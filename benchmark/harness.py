"""What every cell shares: finding a cell's files by name, the port's
config, the spans, the state captures for the check, the import check.

A cell is found by its name in ``BENCHMARK.json``; its configuration file
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``, whose
``driver`` names a module ``drivers/<driver>.py``), limits
(``limits/<cell>.json``) and each metric's reader (``metrics/<metric>.py``)
by theirs. Adding any of them is adding a file.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.judge import Capture

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names nothing in a run may load: JAX, and the repo's
# JAX package and the port's own scripts, whose code the benchmark copies
FORBIDDEN = ("jax", "jaxlib", "flax", "direct_lidar_odometry_tpu", "bench_torch", "chip_smoke",
             "tools_torch")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def deep_update(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    workload: dict
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    limits: dict          # compared number -> limit
    end_to_end: list      # BENCHMARK.json metrics this cell reports, by trace mode
    per_layer: list

    @property
    def dlo(self) -> dict:
        return self.config["dlo"]


def with_candidates(bench: dict | None = None) -> dict:
    """``BENCHMARK.json`` (``bench``) with the entries of ``candidates.json``
    added: the cells kept out of it, which the tests and
    ``control.py`` still run."""
    bench = copy.deepcopy(bench or load_json(ROOT / "BENCHMARK.json"))
    cand = load_json(HERE / "candidates.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + cand.get(key, [])
    return bench


def load_cell(name: str, bench: dict | None = None, scale: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (``bench``), its files found
    by name; ``scale`` deep-overrides the configuration and the traffic
    and the limits (``{"config": {...}, "traffic": {...}, "limits":
    {...}}``: the tests' tiny sizes)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    scale = scale or {}
    config = deep_update(config, scale.get("config", {}))
    traffic = deep_update(traffic, scale.get("traffic", {}))
    limits = deep_update(load_json(HERE / "limits" / f"{name}.json"), scale.get("limits", {}))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, wl, config, traffic, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def port_config(cell: Cell):
    """The port's ``DloConfig`` from the configuration's ``dlo`` block."""
    from direct_lidar_odometry_tpu_torch.config import config_from_dict

    return config_from_dict(cell.dlo)


def _module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path."""
    key = f"benchmark.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def driver(cell: Cell):
    """The module that drives the cell's traffic (``drivers/<driver>.py``)."""
    return _module("drivers", cell.traffic["driver"])


def reader(metric: str):
    """The module that reads ``metric`` (``metrics/<metric>.py``, dots as
    underscores)."""
    return _module("metrics", metric.replace(".", "_"))


class Recorder:
    """Spans (host clock) of one run, kept in memory. A span
    is also a ``torch.profiler`` annotation, so a traced sub-window can
    name what the host was doing during each idle gap. Spans that end
    while the profiler runs (``profiling``) are kept apart, under
    ``<name>@profiled``: tracing slows them."""

    def __init__(self):
        self.spans: dict[str, list[tuple[float, float, int]]] = {}
        self.profiling = False

    @contextmanager
    def span(self, name: str, n: int = 1):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        key = f"{name}@profiled" if self.profiling else name
        self.spans.setdefault(key, []).append((t0, time.perf_counter(), n))


@dataclass
class RunLog:
    """What a driver hands back: the window's counts and clock, the spans,
    the judged frames and the traced sub-window."""

    driver: str
    window_s: float = 0.0
    setup_s: float = 0.0
    frames: int = 0                 # frames (lane-frames) whose pose reached the host
    steps: int = 0                  # lock-step steps (fleet)
    attempted: int = 0
    lost: int = 0                   # frames with no finite pose
    latencies_ms: list = field(default_factory=list)
    queue_ms: list = field(default_factory=list)
    gicp_iters: int = 0
    host_reads: int = 0             # utils/sync.py's count over the window
    rec: Recorder = field(default_factory=Recorder)
    judged: list = field(default_factory=list)   # (judge.Drive, judge.Capture)
    profile: dict | None = None     # the traced sub-window (devprof.window_summary)
    profile_units: int = 0          # frames or steps in it


def percentile(values, q: float) -> float | None:
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def capture_state(state, frame: int, lane: int | None = None):
    """A copy of what the judge follows from the program's state: the
    submap, its member slots and the keyframe ring's poses and spawn
    frames (device copies, enqueued behind the step; no host read)."""
    def take(t):
        return (t if lane is None else t[lane]).clone()

    kf = state.keyframes
    return Capture(frame, take(state.submap_points), take(state.submap_mask),
                   take(state.submap_members), take(kf.positions), take(kf.quats), take(kf.seq))


def pose_rows(poses) -> torch.Tensor:
    """Emitted poses as one float64 host tensor [T, 4, 4]."""
    return torch.stack([p.detach().to("cpu", torch.float64) for p in poses])


def seeded_choice(seed_seq: np.random.SeedSequence, n: int, k: int) -> list[int]:
    rng = np.random.default_rng(seed_seq)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
