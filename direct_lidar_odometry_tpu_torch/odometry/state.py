"""Odometry state: everything carried frame to frame.

Counterpart of the JAX package's ``odometry/state.py`` (reference
``include/dlo/odom.h:75-110``). The JAX package threads an immutable pytree
through a jitted step and donates it so XLA can update the keyframe ring in
place. Here the large buffers — the keyframe ring and the submap cache —
are allocated once by :func:`empty_state` and WRITTEN IN PLACE by the step
(``keyframes.insert``, ``submap.assemble_submap``): a state passed to a
step must not be used again afterwards, exactly as after donation. The
small fields are replaced with ``NamedTuple._replace``.

:func:`state_from_numpy` / :func:`state_to_numpy` convert to and from the
JAX package's ``OdomState`` as numpy arrays keyed by field path
(``"pose"``, ``"keyframes.points"``, ``"submap_grid.start"``, ...), so a
test can carry the reference's state across and step both packages from
it. ``submap_grid`` is the S2M hash index of the ``"hashgrid"`` backend
(``None`` on the others), rebuilt with the submap.

The batched step (``parallel/batched.py``) carries B sequences as one state
whose every tensor has a leading [B] (``batched_state``), the keyframe
ring, the submap cache and the hash grid's leaves included, and returns a
:class:`FrameResult` whose every field is a [B] tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend, submap_flat_size
from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE
from direct_lidar_odometry_tpu_torch.ops import hashgrid


class KeyframeStore(NamedTuple):
    """Preallocated keyframe ring (reference ``keyframes`` vector +
    ``keyframe_normals`` cache, odom.h:80-82). ``count`` tracks occupancy;
    when full, insertion evicts the most redundant keyframe."""

    positions: torch.Tensor      # [K, 3] keyframe pose translations
    quats: torch.Tensor          # [K, 4] keyframe pose rotations (wxyz)
    points: torch.Tensor         # [K, Nk, 3] world-frame keyframe clouds
    masks: torch.Tensor          # [K, Nk]
    normals: torch.Tensor        # [K, Nk, 3] cached normals
    normals_valid: torch.Tensor  # [K, Nk]
    count: torch.Tensor          # int32
    seq: torch.Tensor            # [K] int32 insertion sequence (-1 = never written)
    health: torch.Tensor         # [K] f32 spawn frame's S2M per-correspondence error

    @property
    def capacity(self) -> int:
        return self.positions.shape[-2]


class OdomState(NamedTuple):
    """Full carried state of one odometry sequence."""

    pose: torch.Tensor            # [4, 4] current world pose T
    t_s2s: torch.Tensor           # [4, 4] S2S-propagated pose
    last_delta: torch.Tensor      # [4, 4] inv(pose_{t-1}) @ pose_t
    prev_points: torch.Tensor     # [N, 3] previous scan = next S2S target
    prev_mask: torch.Tensor       # [N]
    prev_normals: torch.Tensor    # [N, 3]
    prev_normals_valid: torch.Tensor  # [N]
    keyframes: KeyframeStore
    submap_members: torch.Tensor  # [K] bool membership of the cached submap
    submap_points: torch.Tensor   # [S_flat, 3] submap cache (written in place)
    submap_mask: torch.Tensor     # [S_flat]
    submap_normals: torch.Tensor  # [S_flat, 3]
    submap_normals_valid: torch.Tensor  # [S_flat]
    submap_grid: hashgrid.HashGrid | None  # S2M hash index ("hashgrid" backend only)
    spaciousness: torch.Tensor    # f32 low-pass median range (<0 = unseeded)
    frame_idx: torch.Tensor       # int32


class FrameResult(NamedTuple):
    """Per-frame outputs. Values the step already read on the host (loop
    counts, branch flags) are Python scalars; the rest are device tensors.
    From the batched step every field is a [B] device tensor (or [B, ...]),
    the loop counts (int32) and branch flags (bool) included."""

    pose: torch.Tensor
    position: torch.Tensor
    quat: torch.Tensor
    new_keyframe: bool
    kf_slot: torch.Tensor         # int32 ring slot written (-1 if none)
    kf_evicted: torch.Tensor      # bool
    num_keyframes: torch.Tensor   # int32
    submap_changed: bool
    spaciousness: torch.Tensor
    keyframe_thresh_dist: torch.Tensor
    s2s_iterations: int
    s2s_error: torch.Tensor
    s2s_num_corr: torch.Tensor
    s2s_converged: bool
    s2m_iterations: int
    s2m_error: torch.Tensor
    s2m_num_corr: torch.Tensor
    s2m_converged: bool


def empty_keyframes(cfg: DloConfig, device) -> KeyframeStore:
    k = cfg.shapes.max_keyframes
    nk = cfg.shapes.n_keyframe
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeStore(
        positions=torch.zeros((k, 3), **f32),
        quats=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(k, 1),
        points=torch.full((k, nk, 3), PAD_VALUE, **f32),
        masks=torch.zeros((k, nk), dtype=torch.bool, device=device),
        normals=torch.zeros((k, nk, 3), **f32),
        normals_valid=torch.zeros((k, nk), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        seq=torch.full((k,), -1, dtype=torch.int32, device=device),
        health=torch.zeros((k,), **f32),
    )


def build_submap_grid(cfg: DloConfig, points: torch.Tensor, mask: torch.Tensor) -> hashgrid.HashGrid | None:
    """The S2M hash index over a submap on the "hashgrid" backend (cell =
    the S2M gate), None on the others; each lane's over [B, S, 3]."""
    if resolve_backend(cfg) != "hashgrid":
        return None
    return hashgrid.build(points, mask, cfg.gicp.s2m.max_correspondence_distance,
                          cfg.shapes.submap_table_size)


def empty_state(
    cfg: DloConfig, initial_pose: torch.Tensor | None = None, device="cuda"
) -> OdomState:
    n = cfg.shapes.n_scan
    k = cfg.shapes.max_keyframes
    s_flat = submap_flat_size(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.eye(4, **f32)
    pose = eye.clone() if initial_pose is None else initial_pose.to(**f32).clone()
    flat_pts = torch.full((s_flat, 3), PAD_VALUE, **f32)
    flat_mask = torch.zeros((s_flat,), dtype=torch.bool, device=device)
    return OdomState(
        pose=pose,
        t_s2s=pose.clone(),
        last_delta=eye.clone(),
        prev_points=torch.full((n, 3), PAD_VALUE, **f32),
        prev_mask=torch.zeros((n,), dtype=torch.bool, device=device),
        prev_normals=torch.zeros((n, 3), **f32),
        prev_normals_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        keyframes=empty_keyframes(cfg, device),
        submap_members=torch.zeros((k,), dtype=torch.bool, device=device),
        submap_points=flat_pts,
        submap_mask=flat_mask,
        submap_normals=torch.zeros((s_flat, 3), **f32),
        submap_normals_valid=torch.zeros((s_flat,), dtype=torch.bool, device=device),
        submap_grid=build_submap_grid(cfg, flat_pts, flat_mask),
        spaciousness=torch.tensor(-1.0, **f32),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def clone_state(state):
    """A copy of a state (or of any nested tuple of tensors, a batched
    state included) on its device: each tensor cloned, None kept. The
    step writes the keyframe ring and the submap cache in place, so a
    reference to a state is not a snapshot of it."""
    return type(state)(*(None if v is None else clone_state(v) if isinstance(v, tuple)
                         else v.clone() for v in state))


def state_to_numpy(state: OdomState) -> dict[str, np.ndarray]:
    """Flatten a state into numpy arrays keyed by field path (a nested
    tuple's fields as ``"keyframes.<field>"``, ``"submap_grid.<field>"``;
    an absent grid has no keys). The arrays are copies, also on the CPU:
    later steps write the ring in place."""
    out = {}
    for name, value in state._asdict().items():
        if value is None:
            continue
        if isinstance(value, tuple):
            for kname, kvalue in value._asdict().items():
                out[f"{name}.{kname}"] = kvalue.detach().to("cpu", copy=True).numpy()
        else:
            out[name] = value.detach().to("cpu", copy=True).numpy()
    return out


def state_from_numpy(
    leaves: dict[str, np.ndarray], device, cfg: DloConfig | None = None
) -> OdomState:
    """Build a state from numpy arrays keyed by field path — e.g. the JAX
    package's ``OdomState`` after N frames; a missing field raises
    ``KeyError``. The ``submap_grid.*`` leaves (the JAX package's S2M hash
    index) are loaded when present; with ``cfg`` they are kept only on the
    "hashgrid" backend, and a "hashgrid" state without them gets its grid
    rebuilt from the loaded submap, so a resumed run searches the submap
    it carries."""

    def tensor(key):
        arr = np.asarray(leaves[key])
        dtype = _DTYPES.get(arr.dtype)
        if dtype is None:
            raise ValueError(f"{key}: unsupported dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=dtype)

    kf = KeyframeStore(**{f: tensor(f"keyframes.{f}") for f in KeyframeStore._fields})
    fields = {f: tensor(f) for f in OdomState._fields if f not in ("keyframes", "submap_grid")}
    grid = None
    if f"submap_grid.{hashgrid.HashGrid._fields[0]}" in leaves:
        grid = hashgrid.HashGrid(**{f: tensor(f"submap_grid.{f}") for f in hashgrid.HashGrid._fields})
    if cfg is not None and resolve_backend(cfg) != "hashgrid":
        grid = None
    elif cfg is not None and grid is None:
        grid = build_submap_grid(cfg, fields["submap_points"], fields["submap_mask"])
    return OdomState(keyframes=kf, submap_grid=grid, **fields)
