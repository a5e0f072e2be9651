"""Cumulative-prefix ablation of the per-frame step.

Port of the JAX package's ``tools/ablate_step.py``.

    python3 tools_torch/ablate_step.py [--small]

``profile_stages.py`` times each stage alone, which overstates the stages
the step skips (the conditional submap rebuild and keyframe spawn) or runs
at reduced resolution (the coarse S2S). This tool times CUMULATIVE
PREFIXES of the port's own ``pipeline.odom_frame``, so that successive
deltas attribute the whole step. The prefixes keep the step's wiring: the
S2S guess of ``pipeline._guess``, the coarse stride with its
``s2s_coarse_max_iterations`` cap, the full-resolution S2S only when
``gicp.s2s_full_polish`` is set (or the stride is 1), the submap's
rebuild-if-changed read, the staged-gate rescue with its host read, and
the keyframe spawn decided on the host. The JAX tool's prefixes differ from
its own step there: they always build and align the full-resolution S2S,
run the coarse align without the cap and leave the rescue out;
``tests/test_torch_stages.py`` holds this tool's full prefix to
``odom_frame`` bit for bit.

The frame is ``bench.py``'s (``bench_torch.production_cfg``, the bench
world, the state after 8 frames through ``OdometryRunner``, frame 8 encoded
as the runner encodes it); the device surrogates
of the hulls stand in for the runner's host hulls, as in the JAX tool. Rows: the dispatch floor (a
near-empty call on the same arguments, then a sync), each stop's
cumulative ms and its delta (best of 3 rounds of ``n`` calls, synced after
each round, the rounds going round-robin over the rows), and
``odom_frame`` itself; each with
``devprof.stage_profile``'s columns (median synced ms, device operations,
busy ms, host reads, K1-K6 launches). Runs on the card and raises without
one; on the CPU call :func:`run` with ``device="cpu"`` and a small config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import make_bench_world, production_cfg  # noqa: E402
from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend  # noqa: E402
from direct_lidar_odometry_tpu_torch.core import cloud as cl, se3  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import (  # noqa: E402
    adaptive, hulls, keyframes, pipeline, submap,
)
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.state import OdomState, clone_state  # noqa: E402
from direct_lidar_odometry_tpu_torch.ops import morton  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device  # noqa: E402
from direct_lidar_odometry_tpu_torch.registration import gicp  # noqa: E402
from direct_lidar_odometry_tpu_torch.utils import sync  # noqa: E402
from tools_torch import devprof  # noqa: E402

STOPS = ("preprocess", "normals", "s2s_coarse", "s2s", "submap", "s2m", "full")
ROUNDS = 3  # the JAX tool's best of 3


# ---------------------------------------------------------------- the wiring
def coarse_stride(cfg: DloConfig) -> int:
    """The coarse S2S stride ``odom_frame`` uses: ``s2s_coarse_stride``,
    lowered until the strided scan keeps whole Morton chunks."""
    cs = max(1, int(cfg.gicp.s2s_coarse_stride))
    while cs > 1 and (cfg.shapes.n_scan // cs) % morton.TARGET_CHUNK != 0:
        cs -= 1
    return cs


def s2s_passes(cfg: DloConfig) -> list:
    """(stride, stage config) of each S2S align ``odom_frame`` runs, in
    order: the capped coarse align when the stride is > 1, then the
    full-resolution align when the stride is 1 or ``s2s_full_polish``."""
    cs = coarse_stride(cfg)
    passes = []
    if cs > 1:
        passes.append((cs, dataclasses.replace(
            cfg.gicp.s2s,
            max_iterations=min(cfg.gicp.s2s_coarse_max_iterations, cfg.gicp.s2s.max_iterations))))
    if cs == 1 or cfg.gicp.s2s_full_polish:
        passes.append((1, cfg.gicp.s2s))
    return passes


def stops(cfg: DloConfig) -> list[str]:
    """The stops of this configuration ("s2s_coarse" only at a stride > 1)."""
    return [s for s in STOPS if s != "s2s_coarse" or coarse_stride(cfg) > 1]


def _strided(tensors, stride: int) -> tuple:
    return tuple(t[::stride].contiguous() for t in tensors) if stride > 1 else tuple(tensors)


def s2s_target(cfg: DloConfig, state: OdomState, backend: str, stride: int) -> gicp.GicpTarget:
    """The S2S target over every ``stride``-th point of the previous scan."""
    prev = _strided((state.prev_points, state.prev_mask, state.prev_normals,
                     state.prev_normals_valid), stride)
    return gicp.make_target(*prev, cfg.gicp.s2s.max_correspondence_distance,
                            cfg.shapes.grid_table_size, backend)


def s2s_aligns(cfg: DloConfig, src: gicp.GicpSource, targets: list, guess: torch.Tensor,
               backend: str) -> list:
    """The S2S aligns of :func:`s2s_passes` on their ``targets``, each
    seeded by the one before; the last is the step's S2S result."""
    results = []
    for (stride, stage), target in zip(s2s_passes(cfg), targets):
        res = gicp.align(gicp.GicpSource(*_strided(src, stride)), target, guess, stage, backend,
                         cfg.shapes.cell_cap_1nn)
        guess = res.transform
        results.append(res)
    return results


def s2m_align(cfg: DloConfig, state: OdomState, src: gicp.GicpSource, guess: torch.Tensor,
              s2s_res: gicp.GicpResult, backend: str) -> gicp.GicpResult:
    """S2M against the state's submap from the S2S-propagated ``guess``,
    then the staged-gate rescue with its host read, as ``odom_frame``."""
    shapes = cfg.shapes
    cap = shapes.cell_cap_1nn
    submap_cloud = (state.submap_points, state.submap_mask, state.submap_normals,
                    state.submap_normals_valid)
    if gicp.is_pallas(backend):
        s2m_target = gicp.make_target(*submap_cloud)
    else:
        s2m_target = gicp.GicpTarget(*submap_cloud, grid=state.submap_grid)
    s2m_res = gicp.align(src, s2m_target, guess, cfg.gicp.s2m, backend, cap)
    if not cfg.gicp.s2m_rescue:
        return s2m_res
    s2s_per = pipeline._per_corr(s2s_res)
    s2m_per = pipeline._per_corr(s2m_res)
    n_valid_src = torch.clamp(torch.sum(src.mask.to(torch.int32)), min=1).to(torch.float32)
    corr_frac = s2m_res.num_correspondences.to(torch.float32) / n_valid_src
    s2m_unhealthy = (
        (s2m_per > cfg.gicp.rescue_s2m_error)
        | (corr_frac < cfg.gicp.rescue_min_corr_frac)
        | (s2m_res.num_correspondences == 0)
    )
    s2s_alarm = (s2s_per > cfg.gicp.rescue_s2s_error) & (
        s2m_per > cfg.gicp.rescue_s2m_corroborate * cfg.gicp.rescue_s2m_error
    )
    if sync.read(s2m_unhealthy | s2s_alarm):
        wide_cfg = dataclasses.replace(
            cfg.gicp.s2m, max_correspondence_distance=cfg.gicp.rescue_corr_distance)
        wide_target = s2m_target
        if backend == "hashgrid":
            wide_target = gicp.make_target(*submap_cloud, cfg.gicp.rescue_corr_distance,
                                           shapes.submap_table_size, backend)
        r1 = gicp.align(src, wide_target, guess, wide_cfg, backend, cap)
        s2m_res = gicp.align(src, s2m_target, r1.transform, cfg.gicp.s2m, backend, cap)
    return s2m_res


def thresh_dist(cfg: DloConfig, spac: torch.Tensor) -> torch.Tensor:
    """The keyframe distance threshold ``odom_frame`` derives from the
    spaciousness."""
    if cfg.adaptive.use:
        return adaptive.keyframe_thresh_from_spaciousness(spac)
    return torch.full_like(spac, cfg.keyframe.thresh_dist)


def prefix(stop: str, cfg: DloConfig | None = None):
    """``odom_frame`` up to and including ``stop``, as a function of
    (state, raw points, raw mask, IMU prior). Returns the stage's output:
    the scan ("preprocess"), its normals ("normals"), the coarse or the
    step's S2S result ("s2s_coarse", "s2s"), the submap cloud ("submap"),
    the S2M result after the rescue ("s2m"), or (keyframe count, spawned,
    pose) ("full", the JAX tool's order). Like ``odom_frame`` it consumes
    the state: the submap cache and the keyframe ring are written in
    place. ``cfg`` defaults to the bench configuration."""
    cfg = production_cfg() if cfg is None else cfg
    if stop not in stops(cfg):
        raise ValueError(f"stop {stop!r} is not one of {stops(cfg)}")
    backend = resolve_backend(cfg)
    directions = {}

    def fn(state, raw_points, raw_mask, imu_prior):
        dev = state.pose.device
        if dev not in directions:
            directions[dev] = torch.from_numpy(
                hulls.fibonacci_directions(cfg.shapes.hull_directions)).to(dev)
        scan = pipeline.preprocess_scan(raw_points, raw_mask, cfg, backend)
        if stop == "preprocess":
            return scan
        spac = adaptive.update_spaciousness(state.spaciousness, scan.points, scan.mask,
                                            cfg.adaptive.lpf_alpha)
        thresh = thresh_dist(cfg, spac)
        nrm = pipeline._scan_normals(scan, cfg, backend)
        if stop == "normals":
            return nrm
        src = gicp.GicpSource(scan.points, scan.mask, nrm.normals, nrm.valid)
        guess = pipeline._guess(cfg, state, imu_prior)
        passes = s2s_passes(cfg)
        if stop == "s2s_coarse":
            passes = passes[:1]
        targets = [s2s_target(cfg, state, backend, stride) for stride, _ in passes]
        s2s_res = s2s_aligns(cfg, src, targets, guess, backend)[-1]
        if stop in ("s2s_coarse", "s2s"):
            return s2s_res
        t_s2s_global = state.t_s2s @ s2s_res.transform
        query_pos = se3.se3_translation(t_s2s_global)
        sel = submap.select_submap_keyframes(state.keyframes, state.submap_members, query_pos,
                                             thresh, cfg, directions[dev])
        state, _ = submap.assemble_submap(state, sel, query_pos, cfg, backend)
        if stop == "submap":
            return cl.PointCloud(state.submap_points, state.submap_mask)
        s2m_res = s2m_align(cfg, state, src, t_s2s_global, s2s_res, backend)
        if stop == "s2m":
            return s2m_res
        pose = torch.where(s2m_res.num_correspondences > 0, s2m_res.transform, t_s2s_global)
        kf, spawned, _, _ = keyframes.maybe_spawn(
            state.keyframes, scan, pose, cfg, thresh, seq=state.frame_idx,
            health=pipeline._per_corr(s2m_res), backend=backend)
        return kf.count, spawned, pose

    return fn


# ------------------------------------------------------------------ the frame
class Frame(NamedTuple):
    cfg: DloConfig
    device: torch.device
    state: OdomState        # after the warm-up frames; clone before a call
    points: torch.Tensor    # the next frame on the wire
    mask: torch.Tensor
    imu_prior: torch.Tensor
    directions: torch.Tensor
    runner: OdometryRunner
    raw: np.ndarray         # the next frame as rendered


def capture_frame(cfg: DloConfig, small: bool = False, device="cuda", frames: int = 8) -> Frame:
    """``bench.py``'s world (``rng(0)``), ``frames`` frames through
    ``OdometryRunner(cfg).process_scan(..., sync=True)``, and the next frame
    encoded as the runner encodes it (``_prep_points``, ``_wire_capacity``):
    with ``host_preprocess`` the device step starts from <= n_scan Z-ordered
    voxel centroids, otherwise from the raw scan."""
    dev = require_device(device)
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(frames + 1, rng, small)
    runner = OdometryRunner(cfg, device=dev)
    for t in range(frames):
        s = synthetic.render_scan(world, t, rng, max_range=max_range, max_points=max_pts,
                                  beams=beams)
        runner.process_scan(s, float(world.stamps[t]), sync=True)
    raw = synthetic.render_scan(world, frames, rng, max_range=max_range, max_points=max_pts,
                                beams=beams)
    wire = cl.from_numpy(runner._prep_points(raw)[:, :3], runner._wire_capacity(), dev)
    return Frame(runner.cfg, dev, runner.state, wire.points, wire.mask,
                 torch.eye(4, dtype=torch.float32, device=dev), runner.directions, runner, raw)


def full_matches_step(fr: Frame) -> dict:
    """``prefix("full")`` against ``pipeline.odom_frame`` on copies of the
    same state and frame: pose, keyframe decision and keyframe count, each
    bit for bit."""
    count, spawned, pose = prefix("full", fr.cfg)(clone_state(fr.state), fr.points, fr.mask,
                                                  fr.imu_prior)
    _, res = pipeline.odom_frame(fr.cfg, fr.directions, clone_state(fr.state), fr.points,
                                 fr.mask, fr.imu_prior)
    return dict(pose_equal=bool(torch.equal(pose, res.pose)),
                new_keyframe_equal=bool(spawned) == bool(res.new_keyframe),
                count_equal=bool(torch.equal(count, res.num_keyframes)),
                new_keyframe=bool(res.new_keyframe), keyframes=int(res.num_keyframes),
                max_pose_diff=float(torch.abs(pose - res.pose).max()))


def best_ms(fns: list, n: int, device, rounds: int = ROUNDS) -> list[float]:
    """The JAX tool's timing of each of ``fns``: after a warm-up call,
    ``rounds`` rounds of ``n`` calls with the device synchronized at the
    end of each; the best round's mean ms a call. The rounds go round-robin
    over ``fns``, so a slow spell of the shared host falls on every
    function alike, not on one row."""
    for fn in fns:
        devprof.synced_ms(fn, device)
    best = [np.inf] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            devprof.synchronize(device)
            best[i] = min(best[i], (time.perf_counter() - t0) / n * 1e3)
    return [float(b) for b in best]


def run(small: bool = False, device="cuda", cfg: DloConfig | None = None, frames: int = 8,
        n: int = 16) -> list[dict]:
    """The ablation rows: "dispatch floor", each stop of :func:`stops`, then
    "odom_frame". Each row: ``stop``, ``cum_ms`` (best of 3 rounds of ``n``
    calls), ``delta_ms`` (against the row before; the floor's against 0,
    ``odom_frame``'s against the full prefix) and ``stage_profile``'s
    columns (median of ``n`` synced calls). The ``odom_frame`` row also
    carries ``full_matches_step`` (the full prefix's pose, keyframe decision
    and count against the step's, bit for bit). ``cfg`` defaults to
    ``production_cfg(small)``; the transfer is not quantized, as in the JAX
    tool."""
    cfg = (production_cfg(small) if cfg is None else cfg).replace(quantize_transfer=False)
    fr = capture_frame(cfg, small, device, frames)
    cfg, dev = fr.cfg, fr.device
    print(f"# device={dev.type} backend={resolve_backend(cfg)} n_scan={cfg.shapes.n_scan} "
          f"stride={coarse_stride(cfg)} polish={cfg.gicp.s2s_full_polish}", file=sys.stderr)
    args = (fr.points, fr.mask, fr.imu_prior)

    def call(fn, st):
        return lambda: fn(st, *args)

    names = ["dispatch floor", *stops(cfg), "odom_frame"]
    fns = [lambda: fr.points[0] + fr.imu_prior[0, 0]]
    fns += [call(prefix(stop, cfg), clone_state(fr.state)) for stop in stops(cfg)]
    fns.append(call(lambda *a: pipeline.odom_frame(cfg, fr.directions, *a),
                    clone_state(fr.state)))
    cum = best_ms(fns, n, dev)
    # deltas: the floor's against 0, each stop's against the stop before,
    # odom_frame's against the full prefix
    prev = [0.0, 0.0, *cum[1:-1]]
    rows = [dict(stop=name, cum_ms=ms, delta_ms=ms - p, **devprof.stage_profile(fn, n, dev))
            for name, fn, ms, p in zip(names, fns, cum, prev)]
    rows[-1]["full_matches_step"] = full_matches_step(fr)
    return rows


def format_row(r: dict) -> str:
    """The JAX tool's columns, then ``stage_profile``'s."""
    return f"{r['stop']:14s} {r['cum_ms']:8.2f} {r['delta_ms']:9.2f}  {devprof.format_profile(r)}"


def parse_argv(argv: list[str]) -> dict:
    """:func:`run`'s arguments from the JAX tool's argv, ``[--small]``
    (also ``profile_stages.py``'s)."""
    unknown = [a for a in argv if a != "--small"]
    if unknown:
        raise SystemExit(f"unknown arguments {unknown}; usage: [--small]")
    return dict(small="--small" in argv)


def main() -> None:
    rows = run(**parse_argv(sys.argv[1:]))
    print(f"{'prefix':14s} {'cum ms':>8s} {'delta ms':>9s}  {devprof.PROFILE_HEADER}")
    for r in rows:
        print(format_row(r))
    for r in rows:
        print(f"# row {json.dumps(r)}")


if __name__ == "__main__":
    main()
