"""Checkpoint/resume of the odometry state (a capability the reference
lacks: SURVEY.md §5, trajectory/keyframes/map live only in RAM).

The JAX package's format v2 (``utils/checkpoint.py``): one compressed npz
whose arrays are keyed by the state's field path (``state/pose``,
``state/keyframes/points``, ...), a ``format_version`` stamp and an
optional ``extra_json`` byte array. Files written here load with the JAX
package's ``load_state`` and files it writes load here: the port's state
has the same fields, dtypes and shapes, the S2M hash index
``submap_grid`` of the "hashgrid" backend included (absent on the other
backends, in both packages). A field missing from the file keeps its
fresh-state value (forward migration, as in the JAX package), except the
hash index, which is rebuilt from the loaded submap; format v1
(positional leaves) is refused.
"""

from __future__ import annotations

import json

import numpy as np

from direct_lidar_odometry_tpu_torch.config import DloConfig
from direct_lidar_odometry_tpu_torch.odometry.state import (
    OdomState,
    empty_state,
    state_from_numpy,
    state_to_numpy,
)

FORMAT_VERSION = 2


def _key(field_path: str) -> str:
    return "state/" + field_path.replace(".", "/")


def save_state(path: str, state: OdomState, extra: dict | None = None) -> None:
    arrays = {_key(k): v for k, v in state_to_numpy(state).items()}
    arrays["format_version"] = np.asarray(FORMAT_VERSION)
    if extra:
        arrays["extra_json"] = np.frombuffer(json.dumps(extra).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, cfg: DloConfig, device="cuda") -> tuple[OdomState, dict]:
    """Restore a state saved under the same config (shapes must match)
    onto ``device``. Returns (state, extra)."""
    data = np.load(path)
    version = int(data["format_version"]) if "format_version" in data else 1
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} is format v{version}; only v{FORMAT_VERSION} "
                         "(field-path keys) can be mapped onto the state")
    template = state_to_numpy(empty_state(cfg, device="cpu"))
    leaves = {k: data[_key(k)] if _key(k) in data else v for k, v in template.items()
              if _key(k) in data or not k.startswith("submap_grid.")}
    for k, v in leaves.items():
        if v.shape != template[k].shape:
            raise ValueError(f"checkpoint {path!r}: {k} has shape {v.shape}, the config "
                             f"needs {template[k].shape}")
    extra = json.loads(bytes(data["extra_json"]).decode()) if "extra_json" in data else {}
    return state_from_numpy(leaves, device, cfg), extra
