"""Long-sequence validation: a closed loop with elevation, driven past
keyframe-ring saturation, with and without loop closure.

Port of the JAX package's ``tools/long_validation.py``. The short drives
cover 25-144 frames; this one reaches the regimes that only appear at
length: keyframe-ring saturation and eviction, submap re-selection on
revisit, a string of loop-closure rounds, drift accumulation. It reports
ATE with and without refinement.

On the card (production shapes):   python3 tools_torch/long_validation.py
Small shapes on the card:          SMALL=1 LV_FRAMES=120 python3 tools_torch/long_validation.py
On the CPU, call :func:`run` (or :func:`drive`) with ``device="cpu"``.

Environment (the JAX tool's): ``SMALL``, ``LV_FRAMES`` (500), ``DEGRADE``
(starve the GICP iteration budget: s2s/s2m max_iterations 3/2, no rescue,
noisier scans), ``LV_NOISE``, ``LV_NOISE_BURST="a:b:sigma"`` (frames [a, b)
rendered with sigma range noise), ``LV_MAX_KF`` (ring capacity with
``SMALL``, 24), ``LV_MIN_GAP`` (20), ``LV_LOOP_RADIUS`` (12.0), ``LV_SOUP``
(the point-soup loop world instead of the ray-cast one). Prints one JSON
line per configuration (posegraph off, then on): the JAX tool's keys, then
what this port adds for the long-drive regime: ``ring_full_frame`` (the
first frame index with the ring full, or null),
``last_unforced_round_frame`` (the frame index of the last round the
trigger ran, or null), ``round_wall_ms`` (each round's wall ms, the forced
one last) and the peak device memory at frame 50 and at the end (MiB; null
on the CPU). Frame indices count from 0, the first scan.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import evaluation, synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.state import clone_state, state_to_numpy  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device  # noqa: E402
from direct_lidar_odometry_tpu_torch.utils import sync  # noqa: E402

MEM_FRAME = 50  # frame index at which the peak device memory is first read

# the JAX tools' small shapes (tools/long_validation.py, staleness_sweep.py, hull_ab.py)
SMALL_SHAPES = dict(
    n_raw=8192, n_scan=8192, n_keyframe=8192, max_submap_kf=8, imu_window=64,
    grid_table_size=2 ** 14, submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
    knn_query_chunk=2048, hull_directions=32,
)


def make_config(small: bool = False, degrade: bool = False, max_kf: int = 24) -> DloConfig:
    """The tool's base configuration: the library defaults with a
    constant-velocity S2S prior, the DEGRADE budget and the SMALL shapes
    (ring of ``max_kf`` slots) when asked."""
    base = DloConfig().replace(s2s_prior="constant_velocity")
    if degrade:
        base = base.replace(gicp=dataclasses.replace(
            base.gicp,
            s2s=dataclasses.replace(base.gicp.s2s, max_iterations=3),
            s2m=dataclasses.replace(base.gicp.s2m, max_iterations=2),
            s2m_rescue=False,
        ))
    if small:
        # a loop-closure A/B needs a ring that keeps the pre-revisit anchor
        # keyframes; the default 24 forces eviction churn (see the JAX tool)
        base = base.replace(shapes=ShapeConfig(max_keyframes=max_kf, **SMALL_SHAPES))
    return base


def with_posegraph(cfg: DloConfig, use: bool, min_gap: int = 20, loop_radius: float = 12.0,
                   check_every: int = 64) -> DloConfig:
    return cfg.replace(posegraph=dataclasses.replace(
        cfg.posegraph, use=use, min_index_gap=min_gap, loop_radius=loop_radius,
        check_every=check_every))


def make_world(frames: int, small: bool = False, soup: bool = False):
    """(world, render kwargs): the ray-cast closed loop with elevation
    (``rng(11)``) of ``frames`` frames, or with ``soup`` the legacy
    point-soup loop world."""
    rng = np.random.default_rng(11)
    if small:
        max_range, max_pts, speed = 13.0, SMALL_SHAPES["n_raw"], 0.4
    else:
        max_range, max_pts, speed = 40.0, ShapeConfig().n_raw, 1.0
    if soup:
        world = synthetic.make_loop_world(
            rng, n_frames=frames, speed=speed, z_amplitude=1.5,
            density=25.0 if not small else 6.0, ground_density=25.0 if not small else 9.0)
        beams = None
    else:
        world = synthetic.make_urban_world(
            rng, n_frames=frames, speed=speed, closed_loop=True, z_amplitude=1.5, n_dynamic=2)
        beams = synthetic.BeamModel(n_beams=32, n_azimuth=512) if small else synthetic.BeamModel()
    return world, dict(max_range=max_range, max_points=max_pts, beams=beams)


def render_scans(world, render: dict, frames: int, noise: float, burst=None, seed: int = 3):
    """The drive's scans, rendered lazily in frame order from one
    ``rng(seed)`` (a 500-frame production world does not fit pre-rendered
    in host memory comfortably); frames [a, b) of ``burst`` = (a, b, sigma)
    get range noise sigma."""
    srng = np.random.default_rng(seed)
    for t in range(frames):
        nz = burst[2] if burst and burst[0] <= t < burst[1] else noise
        yield synthetic.render_scan(world, t, srng, noise=nz, **render)


def gt_poses(world) -> np.ndarray:
    return np.linalg.inv(world.poses[0])[None] @ world.poses


def kf_map_error(state, gt_pos: np.ndarray) -> float:
    """Mean distance of each ring keyframe to its OWN ground-truth position
    (``KeyframeStore.seq`` is the spawn frame index): the map quality a
    loop-closure round repairs, which the end-of-run ATE of poses already
    emitted cannot see."""
    kf = state.keyframes
    n = int(kf.count)
    pos = kf.positions[:n].cpu().numpy()
    seq = kf.seq[:n].cpu().numpy()
    return float(np.linalg.norm(pos - gt_pos[seq], axis=-1).mean())


@contextlib.contextmanager
def reads_by_module(counter: collections.Counter):
    """Count every host read (``utils/sync.read``) under the last part of
    its calling module's name ("gicp", "submap", "keyframes", "pipeline",
    "runner", "loopclosure") while the block runs."""
    read = sync.read

    def counted(t):
        counter[sys._getframe(1).f_globals["__name__"].rpartition(".")[2]] += 1
        return read(t)

    sync.read = counted
    try:
        yield counter
    finally:
        sync.read = read


def gicp_steps() -> collections.Counter:
    """GICP's outer iterations ("linearizations") and LM (or GN) steps
    ("lm_steps") so far, from ``gicp.align``'s own counters
    (``align_iters.<stage>``, ``lm_steps.<stage>``; ``utils/sync.py``),
    counted by its host loop, where a replayed CUDA graph makes no call
    to count: ``align`` reads the host once a step, so the step count is
    what its reads must equal."""
    steps = collections.Counter()
    for name, n in sync.counts.items():
        if name.startswith("align_iters."):
            steps["linearizations"] += n
        elif name.startswith("lm_steps."):
            steps["lm_steps"] += n
    return steps


def drive(cfg: DloConfig, world, scans, device="cuda", t0: float | None = None):
    """Drive ``scans`` (any iterable, in frame order) through one
    ``OdometryRunner(cfg, device)``, each frame synced, then, with loop
    closure on, one forced round.

    Returns (row, trace). ``row`` has the JAX tool's measured keys and this
    port's extras (module docstring). ``trace`` holds per frame (index t):
    ``frame_ms`` (wall ms of ``process_scan``, a triggered round
    included), ``host_reads`` and ``reads_by_module`` (the same reads by
    calling module, :func:`reads_by_module`), ``linearizations`` and
    ``lm_steps`` (GICP's, :func:`gicp_steps`), ``s2s_iterations``,
    ``s2m_iterations``, ``s2m_num_corr`` (None on the first frame),
    ``new_keyframe``, ``kf_slot``, ``kf_evicted``, ``num_keyframes``; and
    ``checks`` (every trigger check: ``frame`` index, the keyframe count
    it read, the count at the last round, ``due`` (the runner's own
    ``_refine_due``) and whether a round ran), ``refine_log`` (the
    runner's, with ``forced`` and the frame ``index`` added), ``seq`` (the
    final ring's, by slot), ``capacity``, ``trajectory``,
    ``state_finite``, ``mem_current_mib`` (allocated at frame MEM_FRAME
    and at the end), the ``runner`` and ``state_before_forced`` (with loop
    closure on, a copy of the runner's state on its device taken just
    before the forced round; else None).
    The per-frame device values are read once, after the drive, so the
    drive's host reads are the runner's own. ``t0``: the start of the
    wall clock of ``row["wall_s"]`` (default: now; the JAX tool's starts
    before its lazy rendering)."""
    dev = require_device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter() if t0 is None else t0
    runner = OdometryRunner(cfg, device=dev)
    pg = cfg.posegraph
    checks, gates = [], []
    trigger, refine_due = runner.maybe_refine, runner._refine_due

    def recorded_due(n_kf: int, force: bool = False) -> bool:
        """The runner's own gates, recorded with the count it read."""
        gates.append((n_kf, refine_due(n_kf, force)))
        return gates[-1][1]

    def recorded_trigger(force: bool = False):
        """The runner's trigger check, recorded (no host read added)."""
        rounds, n_gates, kf_at = len(runner.refine_log), len(gates), runner._kf_at_refine
        out = trigger(force=force)
        if not force:
            n_kf, due = gates[-1] if len(gates) > n_gates else (None, False)
            checks.append(dict(frame=len(runner.poses) - 1, n_keyframes=n_kf,
                               kf_at_refine=kf_at, due=due,
                               ran=len(runner.refine_log) > rounds))
        return out

    runner._refine_due, runner.maybe_refine = recorded_due, recorded_trigger
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    frame_ms, reads, by_module, steps, results = [], [], [], [], []
    mem = {}
    with reads_by_module(collections.Counter()) as sites:
        for t, scan in enumerate(scans):
            before, sites_before, lm_before = sync.counts["host_reads"], sites.copy(), gicp_steps()
            tf = time.perf_counter()
            results.append(runner.process_scan(scan, float(world.stamps[t]), sync=True))
            frame_ms.append((time.perf_counter() - tf) * 1e3)
            reads.append(sync.counts["host_reads"] - before)
            by_module.append(dict(sites - sites_before))
            steps.append(gicp_steps() - lm_before)
            if t == MEM_FRAME and cuda:
                mem["frame"] = (torch.cuda.max_memory_allocated(dev),
                                torch.cuda.memory_allocated(dev))
    if cuda:
        mem["end"] = (torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev))
    n_drive_rounds = len(runner.refine_log)
    gt_all = gt_poses(world)
    gt_pos = gt_all[:, :3, 3]
    err_before = kf_map_error(runner.state, gt_pos)
    before_forced = None
    if pg.use:
        before_forced = clone_state(runner.state)  # the round re-anchors the ring in place
        runner.maybe_refine(force=True)
    err_after = kf_map_error(runner.state, gt_pos)
    est = runner.trajectory()
    gt = gt_all[: len(est)]
    ate = evaluation.ate(est, gt, align=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    wall = time.perf_counter() - t0

    fields = ("kf_slot", "kf_evicted", "num_keyframes", "s2m_num_corr")
    stepped = [r for r in results if r is not None]
    device_rows = iter(torch.stack([torch.stack([getattr(r, f).to(torch.int64) for f in fields])
                                    for r in stepped]).tolist() if stepped else [])
    trace = {key: [] for key in ("new_keyframe", "s2s_iterations", "s2m_iterations") + fields}
    for r in results:
        if r is None:
            frame = dict.fromkeys(trace)
        else:
            frame = dict(zip(fields, next(device_rows)), new_keyframe=bool(r.new_keyframe),
                         s2s_iterations=r.s2s_iterations, s2m_iterations=r.s2m_iterations)
            frame["kf_evicted"] = bool(frame["kf_evicted"])
        for key, value in frame.items():
            trace[key].append(value)
    log = [dict(e, index=e["frame"] - 1, forced=n >= n_drive_rounds)
           for n, e in enumerate(runner.refine_log)]
    cap = cfg.shapes.max_keyframes
    full_at = [t for t, n in enumerate(trace["num_keyframes"]) if n == cap]
    unforced = [e["index"] for e in log if not e["forced"]]
    kf = runner.state.keyframes
    n_kf = runner.num_keyframes()
    mib = 2.0 ** 20
    row = {
        "ate_rmse_m": float(ate.rmse),
        "ate_max_m": float(ate.max),
        "drift_pct": 100.0 * float(ate.rmse) / max(path, 1e-9),
        "path_m": path,
        "keyframes": n_kf,
        "evictions": int(sum(1 for e in trace["kf_evicted"] if e)),
        "refine_rounds": len(runner.refine_log) if pg.use else 0,
        "loop_edges": sum(e["n_accepted"] for e in runner.refine_log) if pg.use else 0,
        "kf_map_err_before_m": err_before,
        "kf_map_err_after_m": err_after,
        "wall_s": wall,
        "ring_full_frame": full_at[0] if full_at else None,
        "last_unforced_round_frame": unforced[-1] if unforced else None,
        "round_wall_ms": [e["wall_ms"] for e in log],
        "peak_mem_frame50_mib": mem["frame"][0] / mib if "frame" in mem else None,
        "peak_mem_end_mib": mem["end"][0] / mib if "end" in mem else None,
    }
    trace.update(
        frame_ms=frame_ms, host_reads=reads, reads_by_module=by_module,
        linearizations=[s["linearizations"] for s in steps],
        lm_steps=[s["lm_steps"] for s in steps], checks=checks,
        refine_log=log, capacity=cap,
        seq=kf.seq[:n_kf].cpu().numpy().tolist(), trajectory=est,
        state_finite=all(np.isfinite(v).all() for v in state_to_numpy(runner.state).values()),
        mem_current_mib={k: v[1] / mib for k, v in mem.items()}, runner=runner,
        state_before_forced=before_forced,
    )
    return row, trace


def run(device="cuda", small: bool = False, frames: int = 500, degrade: bool = False,
        noise: float | None = None, burst: tuple | None = None, max_kf: int = 24,
        min_gap: int = 20, loop_radius: float = 12.0, soup: bool = False) -> list[dict]:
    """The JAX tool's drives: the same world and scans, loop closure off
    then on, each rendered lazily from ``rng(3)``. Returns one row per
    drive: the JAX tool's keys (``frames``, ``degrade``, ``noise``,
    ``posegraph``, ``ate_rmse_m``, ...) and the extras."""
    require_device(device)
    noise = (0.03 if degrade else 0.01) if noise is None else noise
    base = make_config(small, degrade, max_kf)
    world, render = make_world(frames, small, soup)
    rows = []
    for use_pg in (False, True):
        cfg = with_posegraph(base, use_pg, min_gap, loop_radius)
        t0 = time.perf_counter()
        scans = render_scans(world, render, frames, noise, burst)
        row = drive(cfg, world, scans, device, t0=t0)[0]  # drops the runner before the next drive
        rows.append({"frames": frames, "degrade": degrade, "noise": noise, "posegraph": use_pg,
                     **row})
    return rows


def env_args() -> dict:
    """:func:`run`'s arguments from the JAX tool's environment variables."""
    burst = os.environ.get("LV_NOISE_BURST")
    if burst:
        a, b, sigma = burst.split(":")
        burst = (int(a), int(b), float(sigma))
    noise = os.environ.get("LV_NOISE")
    return dict(
        small=bool(int(os.environ.get("SMALL", "0"))),
        frames=int(os.environ.get("LV_FRAMES", "500")),
        degrade=bool(int(os.environ.get("DEGRADE", "0"))),
        noise=None if noise is None else float(noise),
        burst=burst or None,
        max_kf=int(os.environ.get("LV_MAX_KF", "24")),
        min_gap=int(os.environ.get("LV_MIN_GAP", "20")),
        loop_radius=float(os.environ.get("LV_LOOP_RADIUS", "12.0")),
        soup=bool(int(os.environ.get("LV_SOUP", "0"))),
    )


def main() -> None:
    for row in run(device="cuda", **env_args()):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
