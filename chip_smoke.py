#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from ``direct_lidar_odometry_tpu_torch/csrc`` (nvcc,
   sm_90a) and the native host library from ``cpp/dlo_host.cpp`` (g++),
   and print the build times;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the per-frame path at ``cfg/tpu_dlo.yaml`` sizes, from
   Morton-sorted clouds of rendered OS1-64 scans: K2 (1-NN; idx and d2
   bitwise equal to the plain version) with 32768 queries against the
   65536-point submap at r = 0.5, 1.0, 1.5 (S2M), against the previous
   32768-point scan at r = 1.0 (S2S) and at a loop edge's shape (a
   16384-point keyframe against another at the 2 m loop gate); K4 (the
   distance-expansion variant; idx and d2 bitwise equal to its plain
   version except on the r^2 boundary) at the S2M shapes; K1 (radius
   moments) over a 32768-point scan at r = 0.75 and a 16384-point
   keyframe at r = 1.5; K3 (fused GICP linearization) at the S2M shape
   (32768-point scan with K1 normals against the 65536-point submap with
   keyframe normals, r = 0.5) and the S2S shape (32768 x 32768, r = 1.0),
   cold and warm-started (seeded == cold bit for bit, its selection counts
   equal to the plain version's); K5 (exhaustive 1-NN; idx and d2 bitwise
   equal) at 32768 x 65536 and K6 (exhaustive moments; counts identical)
   over the 32768-point scan at r = 0.75, each also with every target
   valid (32768 points of a raw scan) and with the valid targets at random
   slots, with the pairs evaluated (the kernels' device counts) beside the
   pairs the valid targets need. Every kernel runs twice and must repeat
   bit for bit. Prints agreement, median times
   (CUDA events, 20 runs), the pairs each kernel evaluates on these inputs
   (its own candidate counts, or every valid target) and its bound (FLOP
   over the H100's fp32 peak or bytes over its memory rate, the larger),
   and the time of a library call that computes the same function where
   one exists (K5; K2 and K4 at S2M r 0.5: ``torch.cdist``, the minimum,
   then the radius). Then K1-K4 over B = 4 lanes in one launch each, the lanes
   made as ``bench.py`` makes them (lane i of frame t is
   ``render_scan(world, t, rng(100 + i))``, frames 0-4 built as above): K2
   and K4 at S2M r 0.5, K1 over the scans at r 0.75, K3 at S2M r 0.5; every
   lane bitwise equal to its launch alone, the lanes against the plain
   versions as above, and device ms at B = 1, 4 and 8 (the lanes twice)
   beside each launch's bound;
4. drive ``OdometryRunner(cfg, device="cuda")`` (backend "pallas",
   ``cfg/tpu_dlo.yaml`` as shipped, loop closure on) over 30 frames of the
   ray-cast urban world with every launch counter reset just before, and
   check the trajectory (ATE), the S2M correspondences of every frame,
   that K1 and K2 were launched and that no plain version ran; then, on
   each backend ("pallas", "pallas_fused", "pallas_mxu"), profile six
   steady frames of a fresh runner: device operations (kernels, copies,
   sets) per frame, their summed and their merged (overlap counted once)
   device time, by kind and by name, against the wall time of the same
   profiled window;
5. call the port's CLI (``cli.main``) in-process on the same 30 frames at
   full widths, once on backend "pallas_fused" (K3) and once on
   "pallas_mxu" (K4), with ``--eval --map-ply --checkpoint``, counters reset
   before each call: ATE gate, the backend's kernel and K1 launched, K2 and
   every plain version not, a map of > 100 points, a checkpoint that loads,
   the loop-closure counts in the summary;
6. check the drive's last state through the public exhaustive entries
   (the JAX package's oracles): ``query_1nn`` (K5) against the pruned
   search, ``estimate_normals_radius`` (K6) against the carried normals,
   counters reset before;
7. loop closure at full width: 144 frames of a closed-loop urban world
   with a drift burst (frames 40-79 rendered at 11 m range and 0.35 m
   noise), loop closure on, 512-slot ring; then a forced refinement round,
   timed, with the counters reset before it: at least one round and one
   accepted loop edge, the keyframe-map error (each keyframe against its
   own ground truth) lower after the round than before, every state leaf
   finite, K2 launched by the round, no plain version run;
8. the IMU prior and chunked dispatch at full width: the first 40 phase-7
   scans with ``imu.use``, ``gravity_align`` and ``s2s_prior: imu``, after
   1.5 s of static samples, once through ``process_scan`` and once through
   ``process_scan`` + ``process_chunk`` in chunks of 8: the ATE gate on
   both, the two trajectories equal within 1e-5 m, a non-identity IMU prior
   passed to the step, no plain version run; plus the same scans without
   the IMU, for its ATE;
9. print one JSON line of per-kernel results, then the final JSON line
   (after phases 10-17, which run before it);
10. host preprocessing at full width: the native host library (built in
   phase 2) must load; one raw scan
   prepared on the host (``io/hostprep.py``) and on the device must give
   the same valid count and the same points in the same order within
   1e-4 m; then the phase-4 drive with ``host_preprocess`` on ``pallas``
   (ATE gate, S2M correspondences, K1 and K2 launched, no plain version,
   the runner reporting ``"native"``), printed beside phase 4: the max
   pose difference to phase 4's trajectory, host reads a frame, host
   preprocessing ms a frame and the profiled window (device operations,
   busy ms by kernel, idle share); then ``process_chunk`` in chunks of 8
   against ``process_scan`` on the same scans within 1e-5 m;
11. the intensity sidecar and the CLI's KITTI path: the phase-4 world
   written in KITTI layout by ``io/synthetic.dump_kitti`` (OS1-64 beams,
   40 m, xyzi with intensity 1/range), then ``cli.main`` in-process twice
   with host preprocessing, counters reset before each call: with
   ``map.carry_intensity`` (an xyzi PLY of > 100 points, every intensity
   finite and inside the inputs' range, the ATE gate) and without it (the
   scans through the native ``ScanFeeder``, counted); the same host reads
   a frame in both, K1 and K2 launched, no plain version;
12. the ``brute`` and ``hashgrid`` backends on the card: 10 of the phase-4
   frames through ``OdometryRunner(device="cuda")`` on each, with the ATE
   gate, S2M correspondences > 100 and every hand kernel and every plain
   version launched 0 times; prints the wall ms a frame (synced), the host
   reads a frame and the peak device memory, with the card's name and
   power limit; then six steady frames of a fresh runner on each under
   torch.profiler (device operations, busy ms, idle share a frame);
13. the batched step at full width (``parallel/batched.py``): the phase-3
   lanes over 30 frames through ``make_batched_fns`` on "pallas" at B = 4
   (counters reset just before): each lane's ATE gate, lane 0 within 1e-4 m
   of its own single-sequence ``odom_frame(hull_masks=None)`` drive on the
   card with the same keyframe count, K1 and K2 launched and no plain
   version, host reads a step, synced ms a step, peak memory; six steady
   steps profiled (device operations, busy ms, the float64 prefix scan's
   ms, idle share); B = 1 (lane 0) and B = 8 (the lanes twice) over 10
   frames for synced ms, frames/s and peak memory (each B timed over steps
   4-9, B = 4's from its 30-frame drive), and each profiled over those six
   steps (device operations and busy ms a step); "pallas_fused" (K3) and
   "pallas_mxu" (K4) at B = 4 over 10 frames (ATE gate, the backend's
   kernel launched, no plain version); then ``init_distributed`` with NCCL
   at world size 1 on a file store: ``make_sharded_step`` over the first 5
   steps, states and results bitwise equal to the batched drive's and the
   fleet health's ``mean_corr`` equal to the mean of its S2M
   correspondences, and ``make_distributed_refine`` on phase 7's refined
   keyframe graph bitwise equal to ``posegraph.refine``; the group is
   destroyed before the phase ends. The ``kernels`` line gives K1-K4 their
   batched launch counts and device ms at B = 1, 4 and 8;
14. the batched step on the tensor-op backends at full width: phase 13's
   lanes through ``make_batched_fns`` at B = 4, 10 frames on "hashgrid"
   and 5 on "brute" (counters reset just before): each lane's ATE gate and
   S2M correspondences > 100, lane 0 within 1e-4 m of its own
   single-sequence drive on the same backend (bitwise reported), no hand
   kernel and no plain version launched, host reads a step (median and
   max) at most the single drive's + 2, synced ms a step, frames/s and peak
   memory; profiled steps (device operations, busy ms, idle share a step)
   of "hashgrid" at B = 1 and 4 (six steps) and of "brute" at B = 4 (two
   steps); then NCCL at world size 1 on a file store: the sharded step on
   "hashgrid" over 5 steps, states (hash grid included) and results
   bitwise equal to the batched drive's;
15. the long drive past ring saturation, through
   ``tools_torch/long_validation.py``'s ``drive``: its closed loop with
   elevation at full width (OS1-64, 40 m, noise 0.01), 240 frames rendered
   once (the host's scans/s printed), on "pallas" with the tool's
   configuration (loop closure on, ``check_every`` 64, ``min_index_gap``
   20, ``loop_radius`` 12, a forced round at the end), counters reset
   before each drive. Drive A, the 512-slot ring: the ATE gate, at least
   one unforced round, every trigger check whose two gates pass runs its
   round and no other does, S2M correspondences > 100 on every frame, each
   frame without a round reads on the host what its step reads (one read
   a GICP LM step, the steps counted apart from the reads and 1 to
   ``lm_max_iterations`` an outer iteration, and one each for the submap
   flag, the spawn decision and the rescue trigger) plus the trigger's
   count read on a check frame, peak device memory at the end within 64
   MiB of its value at frame 50, finite state, K1 and K2 launched, no
   plain version; each round's frame, keyframes, candidates, accepted
   edges, wall ms and its frame's synced ms, and the keyframe-map error
   before and after the forced round printed. Drive B, the same scans
   with a 24-slot ring and an 8-keyframe submap (flat budget 8 x 16384):
   the same gates except the unforced round and the memory, at least one
   eviction, 24 keyframes at the end, each slot's ``seq`` the frame of the
   last spawn written to it (distinct, in spawn order), at most one
   unforced round with the ring full and none after it; median frame ms
   before and after saturation printed;
16. the graft-entry twin, the loop-closure dissections and the scaling
   tool: ``graft_entry_torch.entry()``'s step once (finite pose, K1 and
   K2 launched, no plain version) and ``dryrun_multichip(1)`` (NCCL at
   world size 1 on a file store; the sharded step and the distributed
   refine, their asserts); ``tools_torch/debug_loopclosure.dissect`` on
   phase 15's drive-A (512 slots) and drive-B (24 slots) states, and of
   ``tools_torch/long_validation.py``'s small noise-burst drive at 24
   slots (``SMALL=1 LV_FRAMES=300 LV_NOISE_BURST=100:140:0.15
   LV_MAX_KF=24``, loop closure on, driven here), each taken just before
   its forced round: the same candidate and accepted-edge
   counts as the round, its 8-iteration graph error the round's bit for
   bit, every row finite, K2 launched, no plain version, the rows
   printed; ``tools_torch/scaling_bench.py`` at N = 1 (one NCCL process,
   its default batch and frames): its rows, a finite positive aggregate
   fps;
17. the stage-attribution tools at their production shapes on "pallas",
   through their ``run`` (``STAGE_REPS`` timed calls a row):
   ``tools_torch/profile_stages`` (each stage of the bench frame alone),
   ``ablate_step`` (cumulative prefixes of ``odom_frame``),
   ``micro_align`` (the align's and the frame's pieces with device
   preprocessing) and ``micro_linearize`` (K2 against fused, seeded and
   unfused linearizations). Every row printed with its synced ms, device
   operations, busy ms, host reads and K1-K6 launches; every time finite
   and > 0, no plain version launched, K1 launched by the normals and by
   the keyframe spawn exactly when it spawns, K2 by the S2S and S2M
   stages, K3 by the fused rows, and the full prefix equal to
   ``odom_frame`` bit for bit (pose, keyframe decision, count); the
   deltas' sum against ``odom_frame`` and the stages' device operations
   against phase 4's frame printed;
18. the bench (``bench_torch.main``, in process, counters reset before each
   call, each line printed behind ``#``): the default run (93 frames,
   three pre-staged passes, synced chunks, a streamed pass, the
   loop-closure check): ATE within the gate, frames/s and the streamed
   frames/s > 0, at least one loop edge and a falling keyframe-map error,
   K1 and K2 launched, no plain version, the second and third passes' and
   the streamed pass's trajectories within 1e-5 m of the first (bitwise
   reported); ``--batch 4 --frames 24`` (frames/s > 0, K1 and K2
   launched); ``--imu --no-loop`` (ATE within the gate); and
   ``--set nn_backend=pallas_fused --no-loop --frames 45`` (K3 launched,
   no plain version).

It imports torch, the port, ``tools_torch``, ``graft_entry_torch`` and
``bench_torch``, nothing of JAX. Each phase's seconds are printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

N_FRAMES = 30
WARMUP = 3
LOOP_FRAMES = 144
BURST = range(40, 80)   # phase 7's degraded stretch
IMU_FRAMES = 40         # phase 8: the phase-7 scans before the burst
CHUNK = 8
TIMING_RUNS = 20
SLOW_RUNS = 5          # timed runs of the K5/K6 yardsticks (tens of ms a call)
SLEEP_CYCLES = 5_000_000  # ~3 ms of device sleep ahead of each timed call
K2_TOL_REL = 2.0**-14   # near-tie slack between two winners' d2
K2_BORDER = 1e-6        # |d2 - r^2| <= K2_BORDER * r^2 counts as on the boundary
K2_FOUND_AGREE = 0.9999
K1_ATOL, K1_RTOL = 1e-3, 1e-5
K4_SLACK = 2e-3          # m^2: the expansion's cancellation error at map-scale coordinates
BACKENDS = ("pallas", "pallas_fused", "pallas_mxu")
K3_REL = 2e-4            # max|dH| <= K3_REL * max|H|, the same form for b and the error
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PROFILED_FRAMES = 6
BACKEND_FRAMES = 10     # phases 12 and 14: frames on "brute" and "hashgrid" (14: "brute" 5)
BRUTE_BATCH_FRAMES = 5  # phase 14: "brute" at B = 4 is ~B times one lane's exhaustive search
HOST_PREP_TOL = 1e-4    # m: host- vs device-prepared scan (JAX tests/test_native.py:76-100)
LANES = 4               # phases 3 and 13: bench.py's batch, lane i rendered with rng(100 + i)
LANE_SWEEP = (1, 4, 8)  # lanes timed; 8 = the 4 lanes twice
SHORT_FRAMES = 10       # phase 13: the pallas_fused / pallas_mxu drives and the B = 1 / 8 timing
SHARDED_STEPS = 5       # phase 13: steps of the NCCL world-size-1 sharded drive
LANE_POSE_TOL = 1e-4    # m: lane 0 of the batched drive against its single-sequence drive
LONG_FRAMES = 240       # phase 15: one lap of the long-validation loop (~240 m)
LONG_RING = 24          # phase 15, drive B: the JAX tool's LV_MAX_KF ring
LONG_SUBMAP_KF = 8      # phase 15, drive B: keyframes in the submap
LONG_MEM_GROWTH_MIB = 64  # phase 15: peak device memory growth allowed after frame 50
# phase 16: the long-validation tool's small noise-burst drive at 24 slots
# (SMALL=1 LV_FRAMES=300 LV_NOISE_BURST=100:140:0.15 LV_MAX_KF=24)
SMALL_BURST_FRAMES = 300
SMALL_BURST = (100, 140, 0.15)
SMALL_BURST_RING = 24
STAGE_REPS = 4          # phase 17: timed calls a row of each stage tool
BENCH_POSE_TOL = 1e-5   # m: phase 18, each bench pass against the first
# phase 15: the step's host reads outside GICP's LM loop: the submap-changed
# flag, the spawn decision, the rescue trigger (one each, every frame)
STEP_FIXED_READS = {"submap": 1, "keyframes": 1, "pipeline": 1}
REPO = Path(__file__).resolve().parent
CFG_PATH = REPO / "cfg" / "tpu_dlo.yaml"
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"


def _load_devprof():
    """``tools_torch/devprof.py`` of this checkout, loaded from its path:
    ``kernel_ab.py`` loads this script beside another tree's packages,
    whose ``tools_torch`` may not have it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_devprof",
                                                  REPO / "tools_torch" / "devprof.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the profiler helpers, under the names kernel_ab.py and older scripts use
_devprof = _load_devprof()
device_events = _devprof.device_events
profile_summary = _devprof.profile_summary
reset_counters = _devprof.reset_launches


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def slice_config(backend: str = "pallas"):
    from direct_lidar_odometry_tpu_torch.config import load_config

    return load_config(str(CFG_PATH), overrides={"nn_backend": backend})


def read_counters() -> dict:
    """Every kernel's launch counter, per route, by wrapper name."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn

    return {
        "nn1_pruned": dict(cuda_nn.launches), "nn1_pruned_mxu": dict(cuda_nn.mxu_launches),
        "nn1_exhaustive": dict(cuda_nn.exhaustive_launches),
        "cov_pruned": dict(cuda_cov.launches), "cov_exhaustive": dict(cuda_cov.exhaustive_launches),
        "fused_linearize": dict(cuda_gicp.launches),
    }


def cuda_median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of one call of ``fn`` between two CUDA events.
    Each run queues the events and the call behind a device sleep of
    SLEEP_CYCLES, so the device runs the call's work back to back and the
    events do not time the host's dispatch of it (a wrapper's Python costs
    more than a short kernel)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of the FLOP over
    the fp32 peak and the bytes over the memory rate, and which it is."""
    t_op = flop / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    """Bytes of the given tensors: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def with_bound(case: dict, flop: float, moved: int) -> dict:
    t, by = bound(flop, moved)
    case.update(flop=flop, bytes=moved, bound_ms=t, bound_by=by, bound_share=t / case["ms"])
    return case


def make_world():
    from direct_lidar_odometry_tpu_torch.io import synthetic

    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=N_FRAMES, speed=1.0, n_dynamic=2)
    beams = synthetic.BeamModel()
    scans = [
        synthetic.render_raycast(world, t, rng, max_range=40.0, max_points=131072, beams=beams)
        for t in range(N_FRAMES)
    ]
    return world, scans


def kernel_inputs(cfg, world, scans, dev):
    """Morton-sorted clouds as the per-frame path builds them: ``queries``,
    the frame-4 scan in the world frame with its K1 normals rotated along
    (queries of K2, K4, K3); ``submap``, the frame 0-3 keyframe clouds with
    their normals (the S2M target); ``s2s``, the frame-3 scan in the world
    frame with its normals (the S2S target); ``scan0`` and ``kf0``, the
    frame-0 scan and keyframe (K1, K6); and a loop edge's shape,
    ``edge_src``, the frame-3 keyframe cloud, against ``edge_tgt``, the
    frame-0 keyframe as a GICP target (both in the world frame, as the
    keyframe store holds them)."""
    from direct_lidar_odometry_tpu_torch.core import cloud as cl, se3
    from direct_lidar_odometry_tpu_torch.odometry import keyframes, pipeline
    from direct_lidar_odometry_tpu_torch.ops import morton
    from direct_lidar_odometry_tpu_torch.registration import gicp

    p0_inv = np.linalg.inv(world.poses[0])

    def scan_at(t):
        raw = cl.from_numpy(scans[t], cfg.shapes.n_raw, dev)
        pose = torch.tensor(p0_inv @ world.poses[t], dtype=torch.float32, device=dev)
        return pipeline.preprocess_scan(raw.points, raw.mask, cfg), pose

    def world_scan(t):
        scan, pose = scan_at(t)
        nrm = pipeline._scan_normals(scan, cfg)
        pts = torch.where(scan.mask[:, None], se3.transform_points(pose, scan.points),
                          cl.PAD_VALUE)
        return gicp.GicpSource(pts.contiguous(), scan.mask,
                               (nrm.normals @ pose[:3, :3].T).contiguous(), nrm.valid)

    kfs, kf_clouds = [], []
    for t in range(4):
        scan, pose = scan_at(t)
        kc, kn = keyframes.make_keyframe_cloud(scan, pose, cfg)
        kfs.append((kc.points, kc.mask, kn.normals, kn.valid))
        kf_clouds.append(kc)
        if t == 0:
            scan0 = scan
    sm_pts, sm_msk, sm_nrm, sm_val = (torch.cat(parts) for parts in zip(*kfs))
    z = morton.sort_order(sm_pts, sm_msk)
    submap = gicp.make_target(*(a[z].contiguous() for a in (sm_pts, sm_msk, sm_nrm, sm_val)))
    return SimpleNamespace(
        queries=world_scan(4), submap=submap, s2s=gicp.make_target(*world_scan(3)),
        scan0=scan0, kf0=kf_clouds[0], edge_src=kf_clouds[3], edge_tgt=gicp.make_target(*kfs[0]))


def library_1nn_ms(queries, targets, radius) -> float:
    """Device ms of the PyTorch call that computes K2's and K4's function:
    every pairwise distance (``torch.cdist``), the minimum, then the radius
    and the query mask (invalid targets sit at the pad coordinate, never
    within the radius)."""
    q, qm, t = queries.points, queries.mask, targets.points

    def library():
        d, i = torch.cdist(q, t).min(dim=1)
        return torch.where(qm & (d <= radius), i, -1)

    return cuda_median_ms(library, SLOW_RUNS)


def check_k2(queries, targets, radius, label, library: bool = False):
    """K2 against its plain version: idx and d2 bitwise equal, and two
    launches bitwise equal. The pairs are counted from the kernel's own
    candidate lists (its ``visits`` output). ``library``: also time the
    PyTorch call that computes the same function."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    q, t = queries.points, targets.points
    args = (q, queries.mask, t, targets.mask, targets.chunk_lo, targets.chunk_hi, radius)
    visits = torch.zeros(q.shape[0] // cuda_nn.SUB_TILE, dtype=torch.int32, device=q.device)
    ik, dk = cuda_nn.nn1_pruned(*args, visits)
    ik2, dk2 = cuda_nn.nn1_pruned(*args)
    ip, dp = cuda_nn.nn1_plain(q, queries.mask, t, targets.mask, radius)
    torch.cuda.synchronize()
    same = bool(torch.equal(ik, ip)) and bool(torch.equal(dk, dp))
    repeat = bool(torch.equal(ik, ik2)) and bool(torch.equal(dk, dk2))
    fk = ik >= 0
    live = visits[visits > 0].float()
    pairs = int(visits.sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK
    ms = cuda_median_ms(lambda: cuda_nn.nn1_pruned(*args))
    plain_ms = cuda_median_ms(lambda: cuda_nn.nn1_plain(q, queries.mask, t, targets.mask, radius))
    case = dict(
        shape=label, radius=radius, queries=int(q.shape[0]), valid=int(queries.mask.sum()),
        targets=int(t.shape[0]), chunks=int(targets.chunk_lo.shape[1]),
        live_subtiles=int(live.numel()), subtiles=int(visits.numel()),
        candidates_mean=float(live.mean()), candidates_max=int(live.max()), pairs=pairs,
        found=int(fk.sum()), identical=same, repeatable=repeat,
        max_abs_err=float(torch.abs(dk[fk] - dp[fk]).max()) if fk.any() else 0.0,
        ms=ms, plain_ms=plain_ms,
        library_ms=library_1nn_ms(queries, targets, radius) if library else None,
    )
    # per pair 3 subtractions, 3 products, 2 additions (no FMA contraction)
    with_bound(case, 8.0 * pairs, nbytes(*args[:6], ik, dk))
    print(f"# K2 nn1_pruned {case}")
    require(same, f"K2 {label} r={radius}: idx or d2 differ from the plain version")
    require(repeat, f"K2 {label} r={radius}: two launches differ")
    require(int(fk.sum()) > 1000, f"K2 {label} r={radius}: only {int(fk.sum())} queries found a neighbour")
    return case


def check_k4(queries, targets, radius, library: bool = False):
    """K4 against its plain version (the same expansion in the same order):
    idx and d2 bitwise equal except found-disagreements within K2_BORDER of
    r^2, two launches bitwise equal, its candidate counts (``visits``, from
    which the pairs come) equal to the plain selection's; then against the
    exact search: found differs only within K4_SLACK of r^2, the winner's
    exact d2 within K4_SLACK of the nearest, and the public entry reports
    the winner's exact d2."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    q, qm, t, tm = queries.points, queries.mask, targets.points, targets.mask
    args = (q, qm, t, tm, targets.chunk_lo, targets.chunk_hi, radius)
    visits = torch.zeros(q.shape[0] // cuda_nn.SUB_TILE, dtype=torch.int32, device=q.device)
    ik, dk = cuda_nn.nn1_pruned_mxu(*args, visits)
    ik2, dk2 = cuda_nn.nn1_pruned_mxu(*args)
    ip, dp = cuda_nn.nn1_mxu_plain(q, qm, t, tm, radius)
    want = cuda_nn.expansion_candidates(q, qm, targets.chunk_lo, targets.chunk_hi, radius)
    ie, de = cuda_nn.nn1_plain(q, qm, t, tm, radius)
    idx, d2, found = cuda_nn.query_1nn_sorted(t, tm, targets.chunk_lo, targets.chunk_hi, q, qm,
                                              radius, mxu=True)
    torch.cuda.synchronize()
    r2 = cuda_nn.f32_radius2(radius)
    fk, fp, fe = ik >= 0, ip >= 0, ie >= 0
    differ = (ik != ip) | (dk != dp)
    on_border = (fk != fp) & (torch.abs(torch.where(fk, dk, dp) - r2) <= K2_BORDER * r2)
    same = not bool((differ & ~on_border).any())
    repeat = bool(torch.equal(ik, ik2)) and bool(torch.equal(dk, dk2))
    visits_same = bool(torch.equal(visits, want.sum(dim=1, dtype=torch.int32)))
    both_p = fk & fp
    win = t[ik.clamp(min=0).long()]
    dxk = torch.sum((q - win) ** 2, dim=-1)  # K4 winner's exact d2
    only_k, only_e, both = fk & ~fe, fe & ~fk, fk & fe
    border_ok = bool(torch.all(torch.abs(dxk[only_k] - r2) < K4_SLACK)) and bool(
        torch.all(torch.abs(de[only_e] - r2) < K4_SLACK))
    gap = float((dxk[both] - de[both]).max()) if both.any() else 0.0
    reported = bool(torch.equal(d2[found], dxk[found])) and bool(torch.equal(idx[found], ik[found].long()))
    live = visits[visits > 0].float()
    pairs = int(visits.sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK
    ms = cuda_median_ms(lambda: cuda_nn.nn1_pruned_mxu(*args))
    plain_ms = cuda_median_ms(lambda: cuda_nn.nn1_mxu_plain(q, qm, t, tm, radius))
    case = dict(
        radius=radius, queries=int(q.shape[0]), targets=int(t.shape[0]),
        live_subtiles=int(live.numel()), candidates_mean=float(live.mean()),
        candidates_max=int(live.max()), exact_candidates=int(cuda_nn.subtile_candidates(
            q, qm, targets.chunk_lo, targets.chunk_hi, radius).sum()), pairs=pairs,
        found=int(fk.sum()), identical=bool(not differ.any()), n_border=int(on_border.sum()),
        repeatable=repeat, visits_equal_plain=visits_same,
        max_abs_err=float(torch.abs(dk[both_p] - dp[both_p]).max()) if both_p.any() else 0.0,
        vs_exact_found_differ=int((fk != fe).sum()), vs_exact_max_d2_gap=gap,
        vs_exact_idx_same=float((ik[both] == ie[both]).float().mean()),
        ms=ms, plain_ms=plain_ms,
        library_ms=library_1nn_ms(queries, targets, radius) if library else None,
    )
    # per pair 3 products and 2 additions for q.t, |q|^2 + |t|^2, 2 q.t, the
    # subtraction and the max; 5 more per staged target for |t|^2
    with_bound(case, 9.0 * pairs + 5.0 * pairs / cuda_nn.SUB_TILE,
               nbytes(*args[:6], ik, dk))
    print(f"# K4 nn1_pruned_mxu {case}")
    require(same, f"K4 r={radius}: idx or d2 differ from the plain version off the r^2 boundary")
    require(repeat, f"K4 r={radius}: two launches differ")
    require(visits_same, f"K4 r={radius}: its candidate counts differ from the plain selection's")
    require(int(fk.sum()) > 1000, f"K4 r={radius}: only {int(fk.sum())} queries found a neighbour")
    require(border_ok, f"K4 r={radius}: found differs from the exact search off the r^2 slack")
    require(gap < K4_SLACK, f"K4 r={radius}: a winner is {gap:.2e} m^2 beyond the nearest")
    require(reported, f"K4 r={radius}: the public entry's d2 is not the winner's exact d2")
    return case


def moments_agree(name, mk, mp, targets, queries, rows, radius):
    """Counts identical on the query ``rows`` except through a pair on the
    r^2 boundary; moments within K1_ATOL + K1_RTOL |plain|. Returns (rows
    whose counts differ, max abs error)."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov

    cnt_same = mk[:, 0] == mp[:, 0]
    n_cnt_diff = int((~cnt_same & rows).sum())
    if n_cnt_diff:
        r2 = cuda_cov.f32_radius2(radius)
        bad = torch.nonzero(~cnt_same & rows)[:, 0]
        d = targets[None, :, :] - queries[bad][:, None, :]
        d2 = torch.sum(d * d, dim=-1)
        on_border = torch.any(torch.abs(d2 - r2) <= K2_BORDER * r2, dim=1)
        require(bool(on_border.all()), f"{name} r={radius}: counts differ off the r^2 boundary")
    keep = rows & cnt_same
    err = torch.abs(mk[keep] - mp[keep])
    close = bool(torch.all(err <= K1_ATOL + K1_RTOL * torch.abs(mp[keep])))
    require(close, f"{name} r={radius}: moments beyond atol {K1_ATOL} rtol {K1_RTOL}")
    return n_cnt_diff, float(err.max())


def check_k1(cloud, radius, label):
    """K1 over a cloud against itself: counts identical except through a
    pair on the r^2 boundary, moments within K1_ATOL + K1_RTOL |plain|, two
    launches bitwise equal; pairs from the kernel's own candidate lists."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn, morton

    p, m = cloud.points, cloud.mask
    clo, chi = morton.chunk_aabbs(p, m, morton.TARGET_CHUNK)
    args = (p, m, p, m, clo, chi, radius)
    visits = torch.zeros(p.shape[0] // cuda_nn.SUB_TILE, dtype=torch.int32, device=p.device)
    mk = cuda_cov.cov_pruned(*args, visits)
    mk2 = cuda_cov.cov_pruned(*args)
    mp = cuda_cov.cov_plain(p, m, p, m, radius)
    torch.cuda.synchronize()
    n_cnt_diff, max_err = moments_agree("K1", mk, mp, p, p, m, radius)
    repeat = bool(torch.equal(mk, mk2))
    live = visits[visits > 0].float()
    pairs = int(visits.sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK
    in_radius = float(mp[m, 0].sum())
    ms = cuda_median_ms(lambda: cuda_cov.cov_pruned(*args))
    plain_ms = cuda_median_ms(lambda: cuda_cov.cov_plain(p, m, p, m, radius))
    case = dict(
        shape=label, radius=radius, points=int(p.shape[0]), valid=int(m.sum()),
        chunks=int(clo.shape[1]), live_subtiles=int(live.numel()), subtiles=int(visits.numel()),
        candidates_mean=float(live.mean()), candidates_max=int(live.max()), pairs=pairs,
        in_radius_pairs=in_radius, mean_neighbours=float(mp[m, 0].mean()),
        n_count_diff=n_cnt_diff, repeatable=repeat, max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, library_ms=None,
    )
    # 8 FLOP per pair for the distance, 16 more inside the radius (the
    # count, 3 offset sums, 6 products and 6 sums)
    with_bound(case, 8.0 * pairs + 16.0 * in_radius, nbytes(p, m, p, m, clo, chi, mk))
    print(f"# K1 cov_pruned {case}")
    require(repeat, f"K1 {label} r={radius}: two launches differ")
    return case


def scattered(points, mask, slots: int, seed: int):
    """The valid points of a cloud at random positions of a ``slots``-slot
    cloud (the rest invalid, at the pad coordinate): the same targets, not
    sorted last and in no spatial order."""
    gen = torch.Generator().manual_seed(seed)
    valid = points[mask]
    where = torch.randperm(slots, generator=gen)[: valid.shape[0]].to(points.device)
    out = torch.full((slots, 3), 1e6, dtype=torch.float32, device=points.device)
    out_mask = torch.zeros(slots, dtype=torch.bool, device=points.device)
    out[where] = valid
    out_mask[where] = True
    return out.contiguous(), out_mask


def dense_cloud(scan: np.ndarray, n: int, dev):
    """``n`` points of a raw scan, every one valid: an even subsample."""
    require(len(scan) >= n, f"the raw scan has {len(scan)} points, fewer than {n}")
    pts = np.ascontiguousarray(scan[:: len(scan) // n][:n, :3], dtype=np.float32)
    return torch.from_numpy(pts).to(dev), torch.ones(n, dtype=torch.bool, device=dev)


def scan_pairs(name, label, stats, n_queries, n_valid):
    """(pairs evaluated, pairs needed) of a K5/K6 launch from its device
    counts: the kernel must have compacted exactly the valid targets and
    scanned less than one 512-target chunk per query tile beyond them."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    counted, chunk_scans = (int(v) for v in stats.cpu())
    evaluated = cuda_nn.TILE * cuda_nn.CHUNK * chunk_scans
    needed = n_queries * n_valid
    require(counted == n_valid, f"{name} {label}: compacted {counted} of {n_valid} valid targets")
    require(needed <= evaluated < needed + n_queries * cuda_nn.CHUNK,
            f"{name} {label}: evaluated {evaluated} pairs for {needed} needed")
    return evaluated, needed


def check_k6(points, mask, queries, radius, label):
    """K6 (every query, no mask) against its plain version on all rows: counts
    identical except through a pair on the r^2 boundary, moments within
    K1_ATOL + K1_RTOL |plain|, two launches bitwise equal, the pairs it
    evaluated (its device counts) against the pairs the valid targets need."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov

    every = torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)
    stats = torch.zeros(2, dtype=torch.int32, device=queries.device)
    mk = cuda_cov.cov_exhaustive(points, mask, queries, radius, stats)
    mk2 = cuda_cov.cov_exhaustive(points, mask, queries, radius)
    mp = cuda_cov.cov_plain(points, mask, queries, every, radius)
    torch.cuda.synchronize()
    n_valid = int(mask.sum())
    evaluated, needed = scan_pairs("K6", label, stats, queries.shape[0], n_valid)
    n_cnt_diff, max_err = moments_agree(f"K6 {label}", mk, mp, points, queries, every, radius)
    repeat = bool(torch.equal(mk, mk2))
    ms = cuda_median_ms(lambda: cuda_cov.cov_exhaustive(points, mask, queries, radius))
    plain_ms = cuda_median_ms(lambda: cuda_cov.cov_plain(points, mask, queries, every, radius),
                              SLOW_RUNS)
    in_radius = float(mp[:, 0].sum())
    case = dict(shape=label, radius=radius, queries=int(queries.shape[0]),
                targets=int(points.shape[0]), valid=n_valid, pairs=needed,
                pairs_evaluated=evaluated, in_radius_pairs=in_radius,
                mean_neighbours=in_radius / queries.shape[0], n_count_diff=n_cnt_diff,
                repeatable=repeat, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                library_ms=None, ps_per_pair=ms * 1e9 / max(evaluated, 1))
    # every query against every valid target (an invalid one is never in
    # the radius) at 8 FLOP a pair, 16 more inside the radius
    with_bound(case, 8.0 * needed + 16.0 * in_radius, nbytes(points, mask, queries, mk))
    print(f"# K6 cov_exhaustive {case}")
    require(repeat, f"K6 {label}: two launches differ")
    return case


def check_k5(queries, targets, tmask, label):
    """K5 against its plain version: raw minima and indices bitwise equal,
    two launches bitwise equal, the pairs it evaluated (its device counts)
    against the pairs the valid targets need."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    args = (queries, targets, tmask)
    stats = torch.zeros(2, dtype=torch.int32, device=queries.device)
    ik, dk = cuda_nn.nn1_exhaustive(*args, stats)
    ik2, dk2 = cuda_nn.nn1_exhaustive(*args)
    ip, dp = cuda_nn.nn1_exhaustive_plain(*args)
    torch.cuda.synchronize()
    n_valid = int(tmask.sum())
    evaluated, needed = scan_pairs("K5", label, stats, queries.shape[0], n_valid)
    same = bool(torch.equal(ik, ip)) and bool(torch.equal(dk, dp))
    repeat = bool(torch.equal(ik, ik2)) and bool(torch.equal(dk, dk2))
    ms = cuda_median_ms(lambda: cuda_nn.nn1_exhaustive(*args))
    plain_ms = cuda_median_ms(lambda: cuda_nn.nn1_exhaustive_plain(*args), SLOW_RUNS)
    # the nearest library yardstick: all pairwise distances, then the minimum
    # (targets as they are, invalid ones at the pad coordinate)
    library_ms = cuda_median_ms(lambda: torch.cdist(queries, targets).min(dim=1), SLOW_RUNS)
    case = dict(shape=label, queries=int(queries.shape[0]), targets=int(targets.shape[0]),
                valid=n_valid, pairs=needed, pairs_evaluated=evaluated, identical=same,
                repeatable=repeat, within_0p5m=int((dk < 0.25).sum()),
                max_abs_err=float(torch.abs(dk - dp).max()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, ps_per_pair=ms * 1e9 / max(evaluated, 1))
    # every query against every valid target, 8 FLOP a pair
    with_bound(case, 8.0 * needed, nbytes(*args, ik, dk))
    print(f"# K5 nn1_exhaustive {case}")
    require(same, f"K5 {label}: idx or d2 differ from the plain version")
    require(repeat, f"K5 {label}: two launches differ")
    return case


def check_exhaustive(inp, scans, dev):
    """K5 and K6 at the per-frame widths (the submap and the scan as the
    pipeline holds them, invalid slots sorted last), with every target valid
    (a 32768-point subsample of a raw scan, where compaction buys nothing,
    for the per-pair rate) and with the same valid targets at random slots
    (about a quarter to a third valid, in no order)."""
    q = inp.queries.points
    dense_p, dense_m = dense_cloud(scans[0], 32768, dev)
    k5 = [check_k5(q, inp.submap.points, inp.submap.mask, "submap"),
          check_k5(q, dense_p, dense_m, "dense"),
          check_k5(q, *scattered(inp.submap.points, inp.submap.mask, 65536, 5), "scattered")]
    scan = inp.scan0
    k6 = [check_k6(scan.points, scan.mask, scan.points, 0.75, "scan"),
          check_k6(dense_p, dense_m, scan.points, 0.75, "dense"),
          check_k6(*scattered(scan.points, scan.mask, 32768, 6), scan.points, 0.75, "scattered")]
    return k5, k6


def check_k3(src, target, radius, label):
    """K3 against its plain version at one GICP shape: correspondences equal
    except 2^-14 near-ties, sub-tile sums within K3_REL of their scale, the
    selection counts (slots 29/30) equal to the plain version's cold and
    warm-started, a warm start (seeds from a perturbed pose) equal to the
    cold pass bit for bit, and two launches equal bit for bit."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.ops import cuda_gicp, cuda_nn
    from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS

    qw = src.mask & src.normals_valid
    tgt = (target.points, target.mask, target.normals, target.normals_valid,
           target.chunk_lo, target.chunk_hi)
    cold = torch.full((src.points.shape[0],), -1, dtype=torch.int32, device=qw.device)

    def run(fn, p, m, seed):
        return fn(p, m, qw, seed, *tgt, radius, PLANE_EPS)

    hk, pk, ik = run(cuda_gicp.fused_linearize_pruned, src.points, src.normals, cold)
    hk2, pk2, ik2 = run(cuda_gicp.fused_linearize_pruned, src.points, src.normals, cold)
    hp, pp, ip = run(cuda_gicp.fused_linearize_plain, src.points, src.normals, cold)
    # seeds: the correspondences of a pose 5 cm / 0.1 degree away
    delta = se3.se3_exp(torch.tensor([0.002, -0.001, 0.002, 0.05, -0.04, 0.03], device=qw.device))
    p_b = torch.where(src.mask[:, None], se3.transform_points(delta, src.points), 1e6).contiguous()
    m_b = (src.normals @ delta[:3, :3].T).contiguous()
    _, _, seed = run(cuda_gicp.fused_linearize_pruned, p_b, m_b, cold)
    hs, ps, is_ = run(cuda_gicp.fused_linearize_pruned, src.points, src.normals, seed)
    hsp, _, _ = run(cuda_gicp.fused_linearize_plain, src.points, src.normals, seed)
    torch.cuda.synchronize()

    fk, fp = ik >= 0, ip >= 0
    dis = ik != ip
    tie = torch.abs(pk[:, 7] - pp[:, 7]) <= K2_TOL_REL * torch.maximum(pk[:, 7], pp[:, 7])
    corr_ok = bool(torch.all(tie[dis] & (fk == fp)[dis]))
    sk, sp = hk[:, :29].sum(0), hp[:, :29].sum(0)
    dh = float((sk[:21] - sp[:21]).abs().max())
    db = float((sk[21:27] - sp[21:27]).abs().max())
    derr = float((sk[27] - sp[27]).abs())
    seeded_same = (bool(torch.equal(is_, ik)) and bool(torch.equal(hs[:, :29], hk[:, :29]))
                   and bool(torch.equal(hs[:, 30], hk[:, 30])) and bool(torch.equal(ps, pk)))
    slots_same = (bool(torch.equal(hk[:, 29:31], hp[:, 29:31]))
                  and bool(torch.equal(hs[:, 29:31], hsp[:, 29:31])))
    repeat = bool(torch.equal(hk, hk2)) and bool(torch.equal(pk, pk2)) and bool(torch.equal(ik, ik2))
    ms = cuda_median_ms(lambda: run(cuda_gicp.fused_linearize_pruned, src.points, src.normals,
                                    cold))
    seeded_ms = cuda_median_ms(lambda: run(cuda_gicp.fused_linearize_pruned, src.points,
                                           src.normals, seed))
    plain_ms = cuda_median_ms(lambda: run(cuda_gicp.fused_linearize_plain, src.points,
                                          src.normals, cold))
    live = hk[:, 29][hk[:, 29] > 0]
    case = dict(
        shape=label, radius=radius, queries=int(src.points.shape[0]), weighted=int(qw.sum()),
        targets=int(target.points.shape[0]), n_corr=int(sp[28]), n_corr_kernel=int(sk[28]),
        corr_differ=int(dis.sum()), max_abs_err=max(dh, db), max_h_err=dh,
        max_abs_h=float(sp[:21].abs().max()), max_b_err=db, max_abs_b=float(sp[21:27].abs().max()),
        error_rel=derr / max(float(sp[27].abs()), 1e-30), seeded_equals_cold=seeded_same,
        slots_equal_plain=slots_same, repeatable=repeat, live_subtiles=int(live.numel()),
        candidates_mean=float(live.mean()), candidates_max=int(live.max()),
        visits_cold=float(hk[:, 29].sum()), visits_seeded=float(hs[:, 29].sum()),
        candidates=float(hk[:, 30].sum()), ms=ms, seeded_ms=seeded_ms, plain_ms=plain_ms,
        library_ms=None,
    )
    # the cold pass's visited pairs at 8 FLOP each, plus ~150 FLOP per
    # weighted query (the others skip the epilogue's maths) for the
    # Mahalanobis matrix and the H/b terms
    pairs = float(hk[:, 29].sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK
    case["pairs"] = pairs
    with_bound(case, 8.0 * pairs + 150.0 * int(qw.sum()),
               nbytes(src.points, src.normals, qw, cold, *tgt, hk, pk, ik))
    print(f"# K3 fused_linearize {case}")
    require(corr_ok, f"K3 {label}: correspondences differ beyond 2^-14 near-ties")
    require(dh <= K3_REL * float(sp[:21].abs().max()), f"K3 {label}: H differs by {dh:.3e}")
    require(db <= K3_REL * float(sp[21:27].abs().max()), f"K3 {label}: b differs by {db:.3e}")
    require(case["error_rel"] <= K3_REL, f"K3 {label}: error differs by {case['error_rel']:.2e}")
    require(seeded_same, f"K3 {label}: the warm-started pass differs from the cold one")
    require(slots_same, f"K3 {label}: slots 29/30 differ from the plain version's selection")
    require(repeat, f"K3 {label}: two launches differ")
    require(int(sp[28]) > 1000, f"K3 {label}: only {int(sp[28])} correspondences")
    return case


def drive(cfg, world, scans, device="cuda", label="main path"):
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import sync

    runner = OdometryRunner(cfg, device=device)
    reset_counters()
    sync.reset()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()  # phase 3's library yardstick held ~9 GB
    reads = []
    for t, scan in enumerate(scans):
        before = sync.counts["host_reads"]
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
        reads.append(sync.counts["host_reads"] - before)
    launches = read_counters()
    est = runner.trajectory()
    rmse, path = ate_of(est, world)
    frame_ms = [s.wall_ms for s in runner.stats]
    corr = [int(s.result.s2m_num_corr) for s in runner.stats[1:]]
    timed = slice(1 + WARMUP, None)
    out = dict(
        frames=len(est), ate_m=rmse, path_m=path, keyframes=runner.num_keyframes(),
        median_ms_per_frame=float(np.median(frame_ms[timed])),
        host_reads_per_frame_median=float(np.median(reads[timed])),
        host_reads_per_frame_mean=float(np.mean(reads[timed])),
        min_s2m_num_corr=min(corr),
        s2s_iterations=[s.result.s2s_iterations for s in runner.stats[1:]],
        s2m_iterations=[s.result.s2m_iterations for s in runner.stats[1:]],
        launches=launches,
        k2_launches_per_frame=launches["nn1_pruned"]["cuda"] / (len(est) - 1),
        k1_launches_per_frame=launches["cov_pruned"]["cuda"] / (len(est) - 1),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(f"# {label} {json.dumps(out)}")
    gate = max(0.10, 0.001 * path)
    require(rmse < gate, f"{label}: ATE {rmse:.4f} m >= {gate:.4f} m")
    require(min(corr) > 100, f"{label}: a frame has s2m_num_corr {min(corr)} <= 100")
    for name in ("nn1_pruned", "cov_pruned"):
        require(launches[name]["cuda"] > 0, f"{label}: {name} kernel was never launched")
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"{label}: {name} plain version ran {cnt['plain']} times")
    return out, runner


def device_ops_per_frame(cfg, world, scans, device="cuda"):
    """Phase 4, continued: PROFILED_FRAMES steady frames of a fresh runner
    on ``cfg``'s backend under torch.profiler (the frames before are the
    runner's warm-up). Per frame: the device operations (kernels, copies,
    sets), their summed device time, the time the device was busy (their
    intervals merged, overlaps counted once), each by kind, the eight
    operations that take the most time, and the wall time of the same
    profiled window, so the idle share compares two times taken under one
    protocol (the profiler slows the host, so the share is higher than
    without it). Reports null where the profiler sees no device activity;
    it does not gate the run."""
    from torch.profiler import ProfilerActivity, profile

    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    runner = OdometryRunner(cfg, device=device)
    first = 1 + WARMUP
    for t in range(first):
        runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
    torch.cuda.synchronize()
    frames = range(first, first + PROFILED_FRAMES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in frames:
            runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(backend=cfg.nn_backend, frames=len(frames))
    out.update(profile_summary(prof, len(frames), wall_ms))
    print(f"# device ops {cfg.nn_backend} {json.dumps(out)}")
    return out


def drive_cli(backend, world, device="cuda"):
    """Phase 5: the port's CLI in-process on backend ``backend`` over the
    synthetic world the CLI renders (the same seed, scans and widths as
    phase 4), counters reset just before."""
    from direct_lidar_odometry_tpu_torch import cli
    from direct_lidar_odometry_tpu_torch.io import evaluation, ply, trajectory
    from direct_lidar_odometry_tpu_torch.utils import checkpoint

    out_dir = OUT_DIR / backend
    argv = ["--synthetic", str(N_FRAMES), "--config", str(CFG_PATH), "--device", device,
            "--set", f"nn_backend={backend}",
            "--out-dir", str(out_dir), "--eval", "--map-ply", "map.ply",
            "--checkpoint", "ckpt.npz", "--dashboard-every", "10"]
    stdout = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv)
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])

    est = trajectory.read_kitti(str(out_dir / "trajectory_kitti.txt"))
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    rmse = evaluation.ate(est, gt, align=False).rmse
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    map_pts = ply.read_ply(str(out_dir / "map.ply"))
    state, extra = checkpoint.load_state(str(out_dir / "ckpt.npz"), slice_config(backend), device)
    ckpt_ok = (int(state.frame_idx) == N_FRAMES
               and np.allclose(state.pose.cpu().numpy()[:3], est[-1][:3], atol=1e-5)
               and extra.get("prev_stamp") == float(world.stamps[N_FRAMES - 1]))
    out = dict(backend=backend, rc=rc, frames=len(est), ate_m=rmse, path_m=path,
               map_points=len(map_pts), checkpoint_ok=ckpt_ok, wall_s=wall_s,
               summary=summary, launches=launches)
    print(f"# cli {json.dumps(out)}")
    kernel = {"pallas_fused": "fused_linearize", "pallas_mxu": "nn1_pruned_mxu"}[backend]
    gate = max(0.10, 0.001 * path)
    require(rc == 0 and len(est) == N_FRAMES, f"cli {backend}: rc {rc}, {len(est)} frames")
    require(rmse < gate, f"cli {backend}: ATE {rmse:.4f} m >= {gate:.4f} m")
    require(launches[kernel]["cuda"] > 0, f"cli {backend}: {kernel} was never launched")
    require(launches["cov_pruned"]["cuda"] > 0, f"cli {backend}: cov_pruned was never launched")
    require(launches["nn1_pruned"]["cuda"] == 0, f"cli {backend}: nn1_pruned was launched")
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"cli {backend}: {name} plain version ran {cnt['plain']} times")
    require(len(map_pts) > 100, f"cli {backend}: the map has {len(map_pts)} points")
    require(ckpt_ok, f"cli {backend}: the checkpoint does not restore the final state")
    require("refine_rounds" in summary and "loop_edges_accepted" in summary,
            f"cli {backend}: the summary has no loop-closure counts")
    return out


def oracle_check(cfg, runner):
    """Phase 6: the last state of the phase-4 drive through the public
    exhaustive entries, the JAX package's test oracles: K5 ``query_1nn`` of
    the last scan (in the world frame) against the submap, held against the
    pruned search; K6 ``estimate_normals_radius`` of the last scan, held
    against the K1 normals the step carried."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn
    from direct_lidar_odometry_tpu_torch.registration import covariance, gicp

    st = runner.state
    reset_counters()
    q = torch.where(st.prev_mask[:, None], se3.transform_points(st.pose, st.prev_points),
                    1e6).contiguous()
    radius = cfg.gicp.s2m.max_correspondence_distance
    i5, d5, f5 = cuda_nn.query_1nn(st.submap_points, st.submap_mask, q, st.prev_mask, radius)
    res = cfg.preprocessing.voxel_scan.res
    n6 = covariance.estimate_normals_radius(st.prev_points, st.prev_mask, 3.0 * res)
    launches = read_counters()
    target = gicp.make_target(st.submap_points, st.submap_mask, st.submap_normals,
                              st.submap_normals_valid)
    i2, d2, f2 = cuda_nn.query_1nn_sorted(target.points, target.mask, target.chunk_lo,
                                          target.chunk_hi, q, st.prev_mask, radius)
    torch.cuda.synchronize()
    dots = torch.abs(torch.sum(n6.normals * st.prev_normals, dim=-1))
    both = n6.valid & st.prev_normals_valid
    out = dict(
        found=int(f5.sum()), found_same=bool(torch.equal(f5, f2)),
        idx_same=float((i5[f5] == i2[f5]).float().mean()),
        max_d2_rel=float((torch.abs(d5[f5] - d2[f5]) / torch.clamp(d2[f5], min=1e-12)).max()),
        normals_valid_same=bool(torch.equal(n6.valid, st.prev_normals_valid)),
        normals_dot_min_p001=float(torch.quantile(dots[both], 0.001)),
        launches=launches,
    )
    print(f"# oracle {json.dumps(out)}")
    require(out["found_same"] and int(f5.sum()) > 1000, "oracle: K5 found differs from K2")
    require(out["idx_same"] == 1.0, "oracle: K5 picked another neighbour than K2")
    require(out["max_d2_rel"] <= 1e-6, "oracle: K5 d2 differs from K2's")
    require(out["normals_valid_same"], "oracle: K6 normal validity differs from K1's")
    for name in ("nn1_exhaustive", "cov_exhaustive"):
        require(launches[name]["cuda"] > 0 and launches[name]["plain"] == 0,
                f"oracle: {name} did not run as a kernel")
    return out


def loop_world(n_raw: int, beams=None):
    """Phase 7's closed-loop urban world and its scans with the drift burst
    of the JAX package's loop-closure check: frames [BURST) at 11 m range
    and 0.35 m range noise, the rest at 40 m and 0.01 m."""
    from direct_lidar_odometry_tpu_torch.io import synthetic

    world = synthetic.make_urban_world(np.random.default_rng(21), n_frames=LOOP_FRAMES,
                                       speed=1.0, closed_loop=True, n_dynamic=0)
    beams = beams or synthetic.BeamModel()
    srng = np.random.default_rng(5)
    scans = []
    for t in range(LOOP_FRAMES):
        burst = t in BURST
        scans.append(synthetic.render_scan(
            world, t, srng, max_range=11.0 if burst else 40.0, max_points=n_raw,
            noise=0.35 if burst else 0.01, beams=beams))
    return world, scans


def loop_config(cfg):
    return cfg.replace(posegraph=dataclasses.replace(
        cfg.posegraph, use=True, min_index_gap=12, loop_radius=12.0, check_every=48,
        refine_every_kf=8))


def sync_device(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ate_of(est, world):
    from direct_lidar_odometry_tpu_torch.io import evaluation

    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    return evaluation.ate(est, gt, align=False).rmse, path


def loop_closure_check(cfg, world, scans, device="cuda"):
    """Phase 7: the 144-frame drive with loop closure on, then a forced
    round, timed with a device sync on both sides."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    runner = OdometryRunner(cfg, device=device)
    reset_counters()
    t0 = time.perf_counter()
    for t, scan in enumerate(scans):
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
    drive_s = time.perf_counter() - t0
    drive_launches = read_counters()
    gt_pos = (np.linalg.inv(world.poses[0])[None] @ world.poses)[:, :3, 3]

    def kf_map_error() -> float:
        kf = runner.state.keyframes
        kfc = int(kf.count)
        pos = kf.positions[:kfc].cpu().numpy()
        return float(np.linalg.norm(pos - gt_pos[kf.seq[:kfc].cpu().numpy()], axis=-1).mean())

    before = kf_map_error()
    rounds_in_drive = len(runner.refine_log)
    reset_counters()
    sync_device(device)
    graphs = []
    t0 = time.perf_counter()
    with recorded_refine(graphs):
        forced = runner.maybe_refine(force=True)
    sync_device(device)
    refine_ms = (time.perf_counter() - t0) * 1e3
    refine_launches = read_counters()
    after = kf_map_error()
    from direct_lidar_odometry_tpu_torch.odometry.state import state_to_numpy

    finite = all(np.isfinite(v).all() for v in state_to_numpy(runner.state).values())
    rmse, path = ate_of(runner.trajectory(), world)
    out = dict(
        frames=len(scans), ring_slots=cfg.shapes.max_keyframes, keyframes=runner.num_keyframes(),
        refine_rounds=len(runner.refine_log), rounds_in_drive=rounds_in_drive,
        loop_edges_accepted=sum(e["n_accepted"] for e in runner.refine_log),
        forced_round=forced, kf_map_err_before_m=before, kf_map_err_after_m=after,
        forced_refine_wall_ms=refine_ms, drive_s=drive_s, ate_m=rmse, path_m=path,
        state_finite=finite, drive_launches=drive_launches, refine_launches=refine_launches,
    )
    print(f"# loop closure {json.dumps(out)}")
    require(len(runner.refine_log) >= 1, "loop closure: no refinement round ran")
    require(out["loop_edges_accepted"] >= 1, "loop closure: no loop edge was accepted")
    require(after < before, f"loop closure: map error {before:.4f} -> {after:.4f} m did not drop")
    require(finite, "loop closure: a state leaf is not finite")
    require(refine_launches["nn1_pruned"]["cuda"] > 0,
            "loop closure: nn1_pruned was not launched by the forced round")
    for launches in (drive_launches, refine_launches):
        for name, cnt in launches.items():
            require(cnt["plain"] == 0, f"loop closure: {name} plain version ran {cnt['plain']} times")
    require(len(graphs) == 1, f"loop closure: the forced round refined {len(graphs)} graphs")
    return out, graphs[0]


@contextlib.contextmanager
def recorded_refine(graphs: list):
    """Record the (graph, iterations) of every ``posegraph.refine`` call."""
    from direct_lidar_odometry_tpu_torch.parallel import posegraph

    refine = posegraph.refine

    def recording(graph, iterations=10, *args, **kwargs):
        graphs.append((graph, iterations))
        return refine(graph, iterations, *args, **kwargs)

    posegraph.refine = recording
    try:
        yield
    finally:
        posegraph.refine = refine


@contextlib.contextmanager
def recorded_priors(priors: list):
    """Record the IMU prior the runner passes to each step."""
    from direct_lidar_odometry_tpu_torch.odometry import pipeline

    step = pipeline.odom_frame

    def recording(cfg, directions, state, points, mask, imu_prior, *args):
        priors.append(imu_prior)
        return step(cfg, directions, state, points, mask, imu_prior, *args)

    pipeline.odom_frame = recording
    try:
        yield
    finally:
        pipeline.odom_frame = step


def imu_chunk_check(cfg, world, scans, device="cuda"):
    """Phase 8: the IMU prior and gravity alignment through process_scan,
    and the same frames through process_chunk (chunks of CHUNK), then the
    frames without the IMU."""
    from direct_lidar_odometry_tpu_torch.core import se3
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    imu_cfg = cfg.replace(gravity_align=True, s2s_prior="imu",
                          imu=dataclasses.replace(cfg.imu, use=True, calib_time=1.0))
    n = len(scans)
    imu_rng = np.random.default_rng(9)
    samples = [synthetic.make_imu_between(world, t, 100.0, imu_rng) for t in range(n)]
    g_body = world.poses[0][:3, :3].T @ np.array([0.0, 0.0, 9.81])

    def new_runner(c):
        r = OdometryRunner(c, device=device)
        for i in range(150):  # 1.5 s static: the calibration window
            r.push_imu(-1.5 + i * 0.01, np.zeros(3), g_body)
        return r

    def push(r, frames):
        for t in frames:
            for row in samples[t]:
                r.push_imu(float(row[0]), row[1:4], row[4:7])

    reset_counters()
    priors = []
    per_frame = new_runner(imu_cfg)
    with recorded_priors(priors):
        for t, scan in enumerate(scans):
            push(per_frame, [t])
            per_frame.process_scan(scan, float(world.stamps[t]), sync=True)
    scan_ms = [s.wall_ms for s in per_frame.stats[1 + WARMUP:]]

    chunked = new_runner(imu_cfg)
    push(chunked, [0])
    chunked.process_scan(scans[0], float(world.stamps[0]), sync=True)
    chunk_ms = []
    for lo in range(1, n, CHUNK):
        hi = min(lo + CHUNK, n)
        push(chunked, range(lo, hi))
        sync_device(device)
        t0 = time.perf_counter()
        chunked.process_chunk(scans[lo:hi], [float(s) for s in world.stamps[lo:hi]])
        sync_device(device)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / (hi - lo))
    launches = read_counters()

    plain = OdometryRunner(cfg, device=device)
    for t, scan in enumerate(scans):
        plain.process_scan(scan, float(world.stamps[t]), sync=True)

    est_scan, est_chunk = per_frame.trajectory(), chunked.trajectory()
    ate_scan, path = ate_of(est_scan, world)
    ate_chunk, _ = ate_of(est_chunk, world)
    ate_no_imu, _ = ate_of(plain.trajectory(), world)
    dev_max = float(np.abs(est_scan[:, :3, 3] - est_chunk[:, :3, 3]).max())
    angles = [float(torch.linalg.norm(se3.so3_log(p[:3, :3]))) for p in priors]
    out = dict(
        frames=n, chunk=CHUNK, ate_imu_process_scan_m=ate_scan, ate_imu_process_chunk_m=ate_chunk,
        ate_no_imu_m=ate_no_imu, path_m=path, chunk_vs_scan_max_m=dev_max,
        prior_angle_max_rad=max(angles), priors=len(angles),
        process_scan_median_ms=float(np.median(scan_ms)),
        process_chunk_median_ms_per_frame=float(np.median(chunk_ms[1:] or chunk_ms)),
        chunk_ms_per_frame=chunk_ms, launches=launches,
    )
    print(f"# imu and chunks {json.dumps(out)}")
    gate = max(0.10, 0.001 * path)
    require(ate_scan < gate, f"imu: process_scan ATE {ate_scan:.4f} m >= {gate:.4f} m")
    require(ate_chunk < gate, f"imu: process_chunk ATE {ate_chunk:.4f} m >= {gate:.4f} m")
    require(dev_max <= 1e-5, f"imu: process_chunk differs from process_scan by {dev_max:.2e} m")
    require(len(est_chunk) == n, f"imu: process_chunk gave {len(est_chunk)} poses for {n} frames")
    require(max(angles) > 1e-4, "imu: every IMU prior passed to the step was the identity")
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"imu: {name} plain version ran {cnt['plain']} times")
    return out


@contextlib.contextmanager
def numpy_wire_encoder():
    """``quantize_for_transfer`` on its numpy path: the native library is
    reported unavailable inside the block."""
    from direct_lidar_odometry_tpu_torch.io import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def host_config(backend: str = "pallas"):
    return slice_config(backend).replace(host_preprocess=True)


def host_preprocess_check(world, scans, phase4, phase4_runner, phase4_profile, host_build_s,
                          device="cuda"):
    """Phase 10: the native host library, one scan prepared on the host and
    on the device, the phase-4 drive with host preprocessing beside phase
    4's, its profiled window, and process_chunk against process_scan."""
    from direct_lidar_odometry_tpu_torch.core import cloud as cl
    from direct_lidar_odometry_tpu_torch.io import hostprep, native
    from direct_lidar_odometry_tpu_torch.odometry import pipeline
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    built = native.available()
    if not built:
        print(f"# native host library failed: {native.load_error()}")
    require(built, "the native host library did not build or load")
    print(f"# native host library loaded (built in {host_build_s:.2f} s, phase 2)")

    cfg = host_config()
    crop, res = cfg.preprocessing.crop.size, cfg.preprocessing.voxel_scan.res
    n_scan = cfg.shapes.n_scan
    prep_ms = []
    for scan in scans:
        t1 = time.perf_counter()
        hostprep.preprocess_morton(scan, crop, res, n_scan)
        prep_ms.append((time.perf_counter() - t1) * 1e3)
    host = hostprep.preprocess_morton(scans[0], crop, res, n_scan)
    raw = cl.from_numpy(scans[0], cfg.shapes.n_raw, device)
    on_device = pipeline.preprocess_scan(raw.points, raw.mask, slice_config())
    dev_pts = on_device.points[on_device.mask].cpu().numpy()
    same_count = len(dev_pts) == len(host)
    order_err = float(np.abs(dev_pts - host).max()) if same_count else float("inf")

    # phase 4 again with core/cloud.py's numpy wire encoder: the native
    # encoder rounds some coordinates one quantum apart from it
    with numpy_wire_encoder():
        numpy_wire, _ = drive(slice_config(), world, scans, device, label="numpy wire encoder")
    out, runner = drive(cfg, world, scans, device, label="host preprocessing")
    pose_diff = float(np.abs(runner.trajectory()[:, :3, 3]
                             - phase4_runner.trajectory()[:, :3, 3]).max())
    profile = device_ops_per_frame(cfg, world, scans, device)

    chunked = OdometryRunner(cfg, device=device)
    chunked.process_scan(scans[0], float(world.stamps[0]), sync=True)
    for lo in range(1, len(scans), CHUNK):
        hi = min(lo + CHUNK, len(scans))
        chunked.process_chunk(scans[lo:hi], [float(s) for s in world.stamps[lo:hi]])
    sync_device(device)
    est_chunk = chunked.trajectory()
    chunk_diff = float(np.abs(est_chunk[:, :3, 3] - runner.trajectory()[:, :3, 3]).max())

    keys = ("device_ops_per_frame", "device_busy_ms_per_frame", "idle_share_profiled",
            "top_ms_per_frame", "busy_ms_per_frame_by_kind")
    summary = dict(
        implementation=runner.host_prep_impl, valid_host=len(host), valid_device=len(dev_pts),
        host_vs_device_max_abs_m=order_err,
        host_prep_ms_per_frame_median=float(np.median(prep_ms)),
        host_prep_ms_per_frame_mean=float(np.mean(prep_ms)),
        ate_m=out["ate_m"], phase4_ate_m=phase4["ate_m"],
        phase4_numpy_wire_ate_m=numpy_wire["ate_m"],
        max_pose_diff_to_phase4_m=pose_diff,
        host_reads_per_frame=out["host_reads_per_frame_median"],
        phase4_host_reads_per_frame=phase4["host_reads_per_frame_median"],
        median_ms_per_frame=out["median_ms_per_frame"],
        phase4_median_ms_per_frame=phase4["median_ms_per_frame"],
        profile={k: profile.get(k) for k in keys},
        phase4_profile={k: phase4_profile.get(k) for k in keys},
        chunk=CHUNK, chunk_vs_scan_max_m=chunk_diff,
    )
    print(f"# host preprocessing vs phase 4 {json.dumps(summary)}")
    require(runner.host_prep_impl == "native",
            f"host preprocessing ran {runner.host_prep_impl!r}, not the native library")
    require(same_count, f"host-prepared scan has {len(host)} points, the device's {len(dev_pts)}")
    require(order_err <= HOST_PREP_TOL,
            f"host- and device-prepared scans differ by {order_err:.2e} m")
    require(len(est_chunk) == len(scans), f"process_chunk gave {len(est_chunk)} poses")
    require(chunk_diff <= 1e-5, f"host preprocessing: process_chunk differs by {chunk_diff:.2e} m")
    return dict(summary, drive=out)


def intensity_cli_check(world, device="cuda", max_range=40.0, max_points=131072, beams=None):
    """Phase 11: the phase-4 world in KITTI layout (OS1-64 beams unless
    ``beams``), then the CLI twice with host preprocessing: with the
    intensity sidecar (xyzi PLY) and without it (the native ScanFeeder)."""
    from direct_lidar_odometry_tpu_torch import cli
    from direct_lidar_odometry_tpu_torch.io import ply, synthetic, trajectory
    from direct_lidar_odometry_tpu_torch.utils import sync

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        t0 = time.perf_counter()
        root = synthetic.dump_kitti(world, tmp, "00", rng=np.random.default_rng(11),
                                    max_range=max_range, max_points=max_points,
                                    beams=beams or synthetic.BeamModel())
        files = sorted(Path(tmp).rglob("*.bin"))
        inten = np.concatenate([np.fromfile(f, np.float32).reshape(-1, 4)[:, 3] for f in files])
        print(f"# wrote {len(files)} KITTI scans in {time.perf_counter() - t0:.1f} s "
              f"(intensity {inten.min():.4f} .. {inten.max():.4f})")
        for intensity in (True, False):
            name = "xyzi" if intensity else "feeder"
            out_dir = OUT_DIR / f"kitti_{name}"
            argv = ["--kitti", root, "--sequence", "00", "--config", str(CFG_PATH),
                    "--device", device, "--set", "nn_backend=pallas",
                    "--set", "host_preprocess=true", "--out-dir", str(out_dir), "--eval",
                    "--map-ply", "map.ply", "--quiet"]
            if intensity:
                argv += ["--set", "map.carry_intensity=true"]
            stdout = io.StringIO()
            reset_counters()
            sync.reset()
            fed = sync.counts["feeder_scans"]
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(argv)
            wall_s = time.perf_counter() - t1
            launches = read_counters()
            est = trajectory.read_kitti(str(out_dir / "trajectory_kitti.txt"))
            rmse, path = ate_of(est, world)
            header = (out_dir / "map.ply").read_bytes()[:512].split(b"end_header")[0]
            m = ply.read_ply(str(out_dir / "map.ply"))
            runs[name] = dict(
                rc=rc, frames=len(est), ate_m=rmse, path_m=path, wall_s=wall_s,
                host_reads_per_frame=sync.counts["host_reads"] / max(len(est), 1),
                feeder_scans=sync.counts["feeder_scans"] - fed,
                map_points=len(m), map_columns=int(m.shape[1]),
                ply_has_intensity=b"property float intensity" in header,
                intensity_min=float(m[:, 3].min()) if m.shape[1] == 4 else None,
                intensity_max=float(m[:, 3].max()) if m.shape[1] == 4 else None,
                intensity_finite=bool(np.isfinite(m).all()),
                summary=json.loads(stdout.getvalue().strip().splitlines()[-1]),
                launches=launches,
            )
    print(f"# intensity and KITTI cli {json.dumps(runs)}")
    for name, run in runs.items():
        gate = max(0.10, 0.001 * run["path_m"])
        require(run["rc"] == 0 and run["frames"] == N_FRAMES,
                f"cli {name}: rc {run['rc']}, {run['frames']} frames")
        require(run["ate_m"] < gate, f"cli {name}: ATE {run['ate_m']:.4f} m >= {gate:.4f} m")
        require(run["map_points"] > 100, f"cli {name}: the map has {run['map_points']} points")
        for kernel in ("nn1_pruned", "cov_pruned"):
            require(run["launches"][kernel]["cuda"] > 0, f"cli {name}: {kernel} never launched")
        for kernel, cnt in run["launches"].items():
            require(cnt["plain"] == 0, f"cli {name}: {kernel} plain version ran {cnt['plain']} times")
    xyzi = runs["xyzi"]
    require(xyzi["ply_has_intensity"] and xyzi["map_columns"] == 4,
            "cli xyzi: the PLY has no intensity property")
    require(xyzi["intensity_finite"], "cli xyzi: a map intensity is not finite")
    require(inten.min() - 1e-6 <= xyzi["intensity_min"] and
            xyzi["intensity_max"] <= inten.max() + 1e-6,
            "cli xyzi: a map intensity lies outside the inputs' range")
    require(xyzi["feeder_scans"] == 0, "cli xyzi: the scans went through the feeder")
    require(runs["feeder"]["feeder_scans"] == N_FRAMES,
            f"cli feeder: {runs['feeder']['feeder_scans']} scans through the native ScanFeeder")
    require(xyzi["host_reads_per_frame"] == runs["feeder"]["host_reads_per_frame"],
            "cli: the intensity sidecar changed the host reads a frame")
    return runs


def backend_check(backend, world, scans, card, device="cuda"):
    """Phase 12: the first BACKEND_FRAMES phase-4 frames on a tensor-op
    backend; no hand kernel and no plain version may launch."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import sync

    runner = OdometryRunner(slice_config(backend), device=device)
    reset_counters()
    sync.reset()
    torch.cuda.reset_peak_memory_stats()
    reads = []
    for t, scan in enumerate(scans[:BACKEND_FRAMES]):
        before = sync.counts["host_reads"]
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
        reads.append(sync.counts["host_reads"] - before)
    launches = read_counters()
    est = runner.trajectory()
    rmse, path = ate_of(est, world)
    corr = [int(s.result.s2m_num_corr) for s in runner.stats[1:]]
    timed = slice(1 + WARMUP, None)
    out = dict(
        backend=backend, card=card, frames=len(est), ate_m=rmse, path_m=path,
        keyframes=runner.num_keyframes(),
        median_ms_per_frame=float(np.median([s.wall_ms for s in runner.stats][timed])),
        host_reads_per_frame_median=float(np.median(reads[timed])),
        host_reads_per_frame_mean=float(np.mean(reads[timed])),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        min_s2m_num_corr=min(corr), grid=runner.state.submap_grid is not None,
        s2m_iterations=[s.result.s2m_iterations for s in runner.stats[1:]],
        launches=launches,
    )
    print(f"# backend {backend} {json.dumps(out)}")
    gate = max(0.10, 0.001 * path)
    require(rmse < gate, f"{backend}: ATE {rmse:.4f} m >= {gate:.4f} m")
    require(min(corr) > 100, f"{backend}: a frame has s2m_num_corr {min(corr)} <= 100")
    for name, cnt in launches.items():
        require(cnt["cuda"] == 0 and cnt["plain"] == 0,
                f"{backend}: {name} launched {cnt['cuda']} times, its plain version {cnt['plain']}")
    return out


def lane_scans(world, n_frames: int, lanes: int = LANES):
    """bench.py's lanes over the phase-4 world: lane i of frame t is
    ``render_scan(world, t, rng(100 + i))`` (OS1-64 beams, 40 m).
    [n_frames][lanes] numpy scans."""
    from direct_lidar_odometry_tpu_torch.io import synthetic

    beams = synthetic.BeamModel()
    return [[synthetic.render_scan(world, t, np.random.default_rng(100 + i), max_range=40.0,
                                   max_points=131072, beams=beams) for i in range(lanes)]
            for t in range(n_frames)]


def stack_lanes(parts):
    """[B] NamedTuples of tensors (or None) -> one with a leading lane
    dimension."""
    return type(parts[0])(*(None if x[0] is None else torch.stack(x).contiguous()
                            for x in zip(*parts)))


def lane_kernel_inputs(cfg, world, lscans, dev):
    """Phase 3, lanes: ``kernel_inputs`` of each lane's first five scans,
    stacked: queries [B, 32768], submaps [B, 65536], scans [B, 32768]."""
    from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud

    per = [kernel_inputs(cfg, world, [frame[i] for frame in lscans[:5]], dev)
           for i in range(len(lscans[0]))]
    return SimpleNamespace(queries=stack_lanes([p.queries for p in per]),
                           submap=stack_lanes([p.submap for p in per]),
                           scan0=PointCloud(*(torch.stack(x) for x in zip(*[p.scan0 for p in per]))))


def at_lanes(tensors, b: int, lanes: int = LANES):
    """Lane 0 alone (unbatched) for b = 1, else the lanes tiled to b."""
    if b == 1:
        return tuple(t[0] for t in tensors)
    return tuple(t.repeat((b // lanes,) + (1,) * (t.dim() - 1)).contiguous() for t in tensors)


def lane_sweep(launch, flop_of, bytes_of, tensors):
    """Device ms of ``launch(*args)`` at B = 1 (lane 0 alone), 4 and 8
    (the lanes twice), each beside its bound from ``flop_of(args)`` (the
    pairs of its own candidate counts) and ``bytes_of(args)``."""
    out = {}
    for b in LANE_SWEEP:
        args = at_lanes(tensors, b)
        ms = cuda_median_ms(lambda: launch(*args))
        flop = flop_of(args)
        t, by = bound(flop, bytes_of(args))
        out[str(b)] = dict(ms=ms, flop=flop, bound_ms=t, bound_by=by, bound_share=t / ms)
    return out


def visited_pairs(fn, args, radius) -> float:
    """Pairs a K1/K2/K4 launch on ``args`` evaluates: 32 x 512 x its
    candidate counts (``visits``), summed over its lanes."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    q = args[0]
    v = torch.zeros(q.shape[:-2] + (q.shape[-2] // cuda_nn.SUB_TILE,), dtype=torch.int32,
                    device=q.device)
    fn(*args, radius, v)
    return float(v.sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK


def check_lanes(lin):
    """Phase 3, lanes: K1-K4 over B = 4 lanes in one launch each (K2 and K4
    at S2M r 0.5, K1 over the scans at r 0.75, K3 at S2M r 0.5, cold). Each
    lane must be bitwise equal to its launch alone (K3: hb rows, payload
    and indices, and H and b through the public entry), and the lanes must
    agree with the plain versions as phase 3 holds them (K2 bitwise, K4
    bitwise off the r^2 boundary, K1 counts off the boundary and moments
    within K1_ATOL + K1_RTOL, K3 correspondences off 2^-14 near-ties and H,
    b and the error within K3_REL of their scale, per lane). Prints device
    ms at B = 1, 4 and 8 with their bounds."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton
    from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS

    q, sm, s0 = lin.queries, lin.submap, lin.scan0
    lanes = q.points.shape[0]
    cases = {}
    r = 0.5
    search = (q.points, q.mask, sm.points, sm.mask, sm.chunk_lo, sm.chunk_hi)
    for name, fn, plain, flop_pair in (("K2", cuda_nn.nn1_pruned, cuda_nn.nn1_plain, 8.0),
                                       ("K4", cuda_nn.nn1_pruned_mxu, cuda_nn.nn1_mxu_plain, 9.0)):
        ik, dk = fn(*search, r)
        alone = [fn(*(a[b] for a in search), r) for b in range(lanes)]
        ip, dp = plain(*search[:4], r)
        torch.cuda.synchronize()
        same_alone = all(torch.equal(ik[b], alone[b][0]) and torch.equal(dk[b], alone[b][1])
                         for b in range(lanes))
        differ = (ik != ip) | (dk != dp)
        if name == "K4":
            r2 = cuda_nn.f32_radius2(r)
            fk, fp = ik >= 0, ip >= 0
            differ &= ~((fk != fp) & (torch.abs(torch.where(fk, dk, dp) - r2) <= K2_BORDER * r2))
        sweep = lane_sweep(lambda *a: fn(*a, r),
                           lambda a: flop_pair * visited_pairs(fn, a, r),
                           lambda a: nbytes(*a) + a[0].shape[:-1].numel() * 8, search)
        cases[name] = dict(lanes=lanes, lanes_equal_alone=same_alone,
                           plain_differ=int(differ.sum()), found=int((ik >= 0).sum()),
                           sweep=sweep)
        require(same_alone, f"{name} lanes: a lane differs from its launch alone")
        require(not bool(differ.any()), f"{name} lanes: the lanes differ from the plain version")

    r = 0.75
    clo, chi = morton.chunk_aabbs(s0.points, s0.mask, morton.TARGET_CHUNK)
    moments = (s0.points, s0.mask, s0.points, s0.mask, clo, chi)
    mk = cuda_cov.cov_pruned(*moments, r)
    alone = [cuda_cov.cov_pruned(*(a[b] for a in moments), r) for b in range(lanes)]
    mp = cuda_cov.cov_plain(*moments[:4], r)
    torch.cuda.synchronize()
    same_alone = all(torch.equal(mk[b], alone[b]) for b in range(lanes))
    agree = [moments_agree("K1 lanes", mk[b], mp[b], s0.points[b], s0.points[b], s0.mask[b], r)
             for b in range(lanes)]
    in_radius = [float(mp[b, :, 0][s0.mask[b]].sum()) for b in range(lanes)]

    def k1_flop(a):
        extra = in_radius[0] if a[0].dim() == 2 else sum(in_radius) * a[0].shape[0] / lanes
        return 8.0 * visited_pairs(cuda_cov.cov_pruned, a, r) + 16.0 * extra

    sweep = lane_sweep(lambda *a: cuda_cov.cov_pruned(*a, r), k1_flop,
                       lambda a: nbytes(*a) + a[0].shape[:-1].numel() * 40, moments)
    cases["K1"] = dict(lanes=lanes, lanes_equal_alone=same_alone,
                       count_diffs=[c for c, _ in agree], max_abs_err=max(e for _, e in agree),
                       sweep=sweep)
    require(same_alone, "K1 lanes: a lane differs from its launch alone")

    r = 0.5
    qw = q.mask & q.normals_valid
    cold = torch.full(qw.shape, -1, dtype=torch.int32, device=qw.device)
    tgt = (sm.points, sm.mask, sm.normals, sm.normals_valid, sm.chunk_lo, sm.chunk_hi)
    fused = (q.points, q.normals, qw, cold, *tgt)
    hk, pk, ik = cuda_gicp.fused_linearize_pruned(*fused, r, PLANE_EPS)
    hp, pp, ip = cuda_gicp.fused_linearize_plain(*fused, r, PLANE_EPS)
    fl = cuda_gicp.fused_linearize(*tgt, q.points, q.normals, qw, r, PLANE_EPS)
    same_alone = True
    for b in range(lanes):
        one = cuda_gicp.fused_linearize_pruned(*(a[b] for a in fused), r, PLANE_EPS)
        same_alone &= all(bool(torch.equal(x[b], y)) for x, y in zip((hk, pk, ik), one))
        solo = cuda_gicp.fused_linearize(*(t[b:b + 1] for t in tgt), q.points[b:b + 1],
                                         q.normals[b:b + 1], qw[b:b + 1], r, PLANE_EPS)
        same_alone &= bool(torch.equal(fl.h[b], solo.h[0])) and bool(torch.equal(fl.b[b], solo.b[0]))
    torch.cuda.synchronize()
    dis = ik != ip
    tie = torch.abs(pk[..., 7] - pp[..., 7]) <= K2_TOL_REL * torch.maximum(pk[..., 7], pp[..., 7])
    corr_ok = bool(torch.all(tie[dis] & ((ik >= 0) == (ip >= 0))[dis]))
    sk, sp = hk[..., :29].sum(1), hp[..., :29].sum(1)

    def lane_rel(lo: int, hi: int) -> float:
        """Largest over the lanes of max|d| / max|plain| of slots lo:hi."""
        return float(((sk[:, lo:hi] - sp[:, lo:hi]).abs().amax(1)
                      / sp[:, lo:hi].abs().amax(1).clamp(min=1e-30)).max())

    h_rel, b_rel, err_rel = lane_rel(0, 21), lane_rel(21, 27), lane_rel(27, 28)

    def k3_flop(a):
        hb = cuda_gicp.fused_linearize_pruned(*a, r, PLANE_EPS)[0]
        pairs = float(hb[..., 29].sum()) * cuda_nn.SUB_TILE * cuda_nn.CHUNK
        return 8.0 * pairs + 150.0 * float(a[2].sum())

    sweep = lane_sweep(lambda *a: cuda_gicp.fused_linearize_pruned(*a, r, PLANE_EPS), k3_flop,
                       lambda a: nbytes(*a) + a[0].shape[:-1].numel() * 40, fused)
    cases["K3"] = dict(lanes=lanes, lanes_equal_alone=same_alone, corr_differ=int(dis.sum()),
                       max_h_rel=h_rel, max_b_rel=b_rel, error_rel=err_rel, sweep=sweep)
    require(same_alone, "K3 lanes: a lane differs from its launch alone")
    require(corr_ok, "K3 lanes: correspondences differ from the plain version beyond near-ties")
    require(h_rel <= K3_REL, f"K3 lanes: H differs from the plain version by {h_rel:.2e}")
    require(b_rel <= K3_REL, f"K3 lanes: b differs from the plain version by {b_rel:.2e}")
    require(err_rel <= K3_REL, f"K3 lanes: the error differs from the plain version by {err_rel:.2e}")
    for name, case in cases.items():
        print(f"# lanes {name} {json.dumps(case)}")
    return cases


def device_frames(lscans, n_raw: int, dev):
    """[T][B] numpy scans -> [T] (points [B, n_raw, 3], mask [B, n_raw]) on
    the card (placed before any timing, as bench.py places its lanes)."""
    from direct_lidar_odometry_tpu_torch.core import cloud as cl

    out = []
    for scans in lscans:
        clouds = [cl.from_numpy(s, n_raw, dev) for s in scans]
        out.append((torch.stack([c.points for c in clouds]), torch.stack([c.mask for c in clouds])))
    return out


def batched_drive(cfg, world, frames, label, snapshot_at=None):
    """Phase 13: ``make_batched_fns(cfg)`` over ``frames`` (every launch
    counter and the host-read count reset just before), each step synced:
    each lane's ATE, the synced ms a step (steady steps: after WARMUP), the
    host reads a step, the peak device memory, the launches. Returns
    (summary, [FrameResult], state after step ``snapshot_at`` (a copy) or
    None)."""
    from direct_lidar_odometry_tpu_torch.odometry.state import clone_state
    from direct_lidar_odometry_tpu_torch.parallel import batched
    from direct_lidar_odometry_tpu_torch.utils import sync

    b = frames[0][0].shape[0]
    init_fn, step_fn = batched.make_batched_fns(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    sync.reset()
    dev = frames[0][0].device
    states = init_fn(batched.batched_state(cfg, b, dev), *frames[0])
    eye = torch.eye(4, device=dev).expand(b, 4, 4).clone()
    results, step_ms, reads, snapshot = [], [], [], None
    for t in range(1, len(frames)):
        torch.cuda.synchronize()
        before = sync.counts["host_reads"]
        t0 = time.perf_counter()
        states, res = step_fn(states, *frames[t], eye)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(sync.counts["host_reads"] - before)
        results.append(res)
        if t == snapshot_at:
            snapshot = clone_state(states)
    launches = read_counters()
    poses = torch.stack([r.pose for r in results]).cpu().numpy()      # [T-1, B, 4, 4]
    ates = []
    for lane in range(b):
        est = np.concatenate([np.eye(4, dtype=np.float32)[None], poses[:, lane]])
        ates.append(ate_of(est, world))
    path = ates[0][1]
    steady = step_ms[WARMUP:] or step_ms
    ms = float(np.median(steady))
    out = dict(
        label=label, backend=cfg.nn_backend, lanes=b, frames=len(frames),
        ate_m=[a for a, _ in ates], path_m=path, synced_ms_per_step_median=ms,
        frames_per_s=b * 1e3 / ms, synced_ms_per_step=step_ms, host_reads_per_step=reads,
        host_reads_per_step_median=float(np.median(reads[WARMUP:] or reads)),
        keyframes=[int(k) for k in results[-1].num_keyframes.cpu()],
        min_s2m_num_corr=int(torch.stack([r.s2m_num_corr for r in results]).min()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
    )
    print(f"# batched {label} {json.dumps(out)}")
    gate = max(0.10, 0.001 * path)
    for lane, (ate, _) in enumerate(ates):
        require(ate < gate, f"batched {label}: lane {lane} ATE {ate:.4f} m >= {gate:.4f} m")
    require(out["min_s2m_num_corr"] > 100, f"batched {label}: a lane has <= 100 S2M correspondences")
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"batched {label}: {name} plain version ran {cnt['plain']} times")
    return out, results, snapshot


def single_lane_drive(cfg, frames, lane: int = 0):
    """Phases 13 and 14: lane ``lane`` of ``frames`` through the
    single-sequence step on the card, ``odom_frame(hull_masks=None)``
    driven directly: (poses [T-1, 4, 4], keyframe count, host reads a
    frame)."""
    from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline
    from direct_lidar_odometry_tpu_torch.utils import sync

    dev = frames[0][0].device
    directions = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions)).to(dev)
    st = pipeline.init_frame(cfg, pipeline.fresh_state(cfg, device=dev), frames[0][0][lane],
                             frames[0][1][lane])
    poses, reads = [], []
    for pts, mask in frames[1:]:
        before = sync.counts["host_reads"]
        st, res = pipeline.odom_frame(cfg, directions, st, pts[lane], mask[lane],
                                      torch.eye(4, device=dev), hull_masks=None)
        reads.append(sync.counts["host_reads"] - before)
        poses.append(res.pose)
    return torch.stack(poses), int(st.keyframes.count), reads


def batched_profile(cfg, frames, warmup: int = WARMUP, steps: int = PROFILED_FRAMES):
    """Phases 13 and 14: ``steps`` steady batched steps (after 1 +
    ``warmup``) under torch.profiler: device operations, busy ms, idle
    share and the prefix scan's ms a step."""
    from torch.profiler import ProfilerActivity, profile

    from direct_lidar_odometry_tpu_torch.parallel import batched

    b = frames[0][0].shape[0]
    init_fn, step_fn = batched.make_batched_fns(cfg)
    dev = frames[0][0].device
    states = init_fn(batched.batched_state(cfg, b, dev), *frames[0])
    eye = torch.eye(4, device=dev).expand(b, 4, 4).clone()
    first = 1 + warmup
    for t in range(1, first):
        states, _ = step_fn(states, *frames[t], eye)
    torch.cuda.synchronize()
    steps = range(first, first + steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in steps:
            states, _ = step_fn(states, *frames[t], eye)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(backend=cfg.nn_backend, lanes=b, steps=len(steps))
    out.update(profile_summary(prof, len(steps), wall_ms, unit="step"))
    print(f"# batched profile {json.dumps(out)}")
    return out


def sharded_check(cfg, frames, results, snapshot, refine_graph=None, label="phase 13"):
    """Phases 13 and 14: ``init_distributed`` with NCCL at world size 1 (a
    file store in a temporary directory, so no port), the sharded step over
    the first SHARDED_STEPS steps of the batched drive's lanes, states (the
    hash grid's leaves included, where the backend has one) and results
    bitwise equal to the batched drive's, the fleet health (mean_corr equal
    to the mean of the drive's S2M correspondences); then, given
    ``refine_graph``, ``make_distributed_refine`` on the phase-7 keyframe
    graph, bitwise equal to ``posegraph.refine``. The group is destroyed
    before the phase ends."""
    import torch.distributed as dist

    from direct_lidar_odometry_tpu_torch.parallel import batched, posegraph, sharded

    def leaves(st):
        out = []
        for v in st:
            if isinstance(v, tuple):
                out.extend(v)
            elif v is not None:
                out.append(v)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        sharded.init_distributed(f"file://{tmp}/store", num_processes=1, process_id=0)
        try:
            backend = dist.get_backend()
            require(backend == "nccl", f"the group runs {backend}, not nccl")
            mesh = sharded.make_mesh(1)
            init_fn, _ = batched.make_batched_fns(cfg)
            step = sharded.make_sharded_step(cfg, mesh)
            lanes = frames[0][0].shape[0]
            states = init_fn(sharded.shard_states(batched.batched_state(cfg, lanes, mesh.device),
                                                  mesh),
                             *sharded.shard_states(frames[0], mesh))
            eye = torch.eye(4, device=mesh.device).expand(lanes, 4, 4).clone()
            same, health = True, []
            for t in range(1, SHARDED_STEPS + 1):
                states, res, mean_corr, max_err = step(states, *sharded.shard_states(frames[t], mesh),
                                                       eye)
                ref = results[t - 1]
                same &= all(bool(torch.equal(a, b)) for a, b in zip(res, ref))
                want = ref.s2m_num_corr.to(torch.float32).mean()
                health.append(dict(mean_corr=float(mean_corr), max_err=float(max_err),
                                   mean_corr_equal=bool(torch.equal(mean_corr, want))))
            got, want = leaves(states), leaves(snapshot)
            same_state = len(got) == len(want) and all(bool(torch.equal(a, b))
                                                       for a, b in zip(got, want))
            refine_same, refine = True, {}
            if refine_graph is not None:
                graph, iterations = refine_graph
                poses_d, err_d = sharded.make_distributed_refine(mesh, iterations)(graph)
                poses_s, err_s = posegraph.refine(graph, iterations=iterations)
                torch.cuda.synchronize()
                refine_same = bool(torch.equal(poses_d, poses_s)) and bool(torch.equal(err_d, err_s))
                refine = dict(refine_edges=int(graph.edges.shape[0]), refine_iterations=iterations,
                              refine_equal=refine_same)
            sharded.barrier(label)
        finally:
            dist.destroy_process_group()
    out = dict(backend=backend, nn_backend=cfg.nn_backend, world=1, steps=SHARDED_STEPS,
               results_equal=same, states_equal=same_state, state_leaves=len(got),
               health=health, **refine)
    print(f"# sharded {json.dumps(out)}")
    require(same, "sharded: a result of the world-size-1 sharded step differs from the batched step")
    require(same_state, "sharded: the sharded states differ from the batched drive's")
    require(all(h["mean_corr_equal"] for h in health),
            "sharded: mean_corr differs from the mean of the lanes' S2M correspondences")
    require(refine_same, "sharded: the distributed refine differs from posegraph.refine")
    return out


def batch_phase(world, lscans, refine_graph, card):
    """Phase 13: the batched step at full width on the card (pallas at B = 4
    over 30 frames, lane 0 against its single-sequence drive, the profiled
    window, B = 1 / 4 / 8 timing; pallas_fused and pallas_mxu at B = 4 over
    SHORT_FRAMES), then the NCCL world-size-1 sharded forms."""
    cfg = slice_config("pallas")
    dev = torch.device("cuda")
    frames = device_frames(lscans, cfg.shapes.n_raw, dev)
    main, results, snapshot = batched_drive(cfg, world, frames, "pallas B=4",
                                            snapshot_at=SHARDED_STEPS)
    for name in ("nn1_pruned", "cov_pruned"):
        require(main["launches"][name]["cuda"] > 0, f"batched pallas: {name} was never launched")
    single, single_kf, _ = single_lane_drive(cfg, frames)
    lane0 = torch.stack([r.pose[0] for r in results])
    lane_diff = float((lane0[:, :3, 3] - single[:, :3, 3]).abs().max())
    require(lane_diff <= LANE_POSE_TOL,
            f"batched: lane 0 is {lane_diff:.2e} m from its single-sequence drive")
    require(main["keyframes"][0] == single_kf,
            f"batched: lane 0 has {main['keyframes'][0]} keyframes, its single drive {single_kf}")
    profile = batched_profile(cfg, frames)
    # every B over the same steady steps: 4-9 of the first SHORT_FRAMES frames
    steady = slice(WARMUP, SHORT_FRAMES - 1)
    ms4 = float(np.median(main["synced_ms_per_step"][steady]))
    sweep = {str(LANES): dict(synced_ms_per_step=ms4, frames_per_s=LANES * 1e3 / ms4,
                              peak_mem_gib=main["peak_mem_gib"],
                              device_ops_per_step=profile.get("device_ops_per_step"),
                              device_busy_ms_per_step=profile.get("device_busy_ms_per_step"))}
    for b in LANE_SWEEP:
        if b == LANES:
            continue
        # B = 1: lane 0 alone; B = 8: the four lanes twice
        short = [tuple(t[:1] if b == 1 else t.repeat(b // LANES, *(1,) * (t.dim() - 1))
                       for t in f) for f in frames[:SHORT_FRAMES]]
        out, _, _ = batched_drive(cfg, world, short, f"pallas B={b}")
        ms = float(np.median(out["synced_ms_per_step"][steady]))
        prof_b = batched_profile(cfg, short)
        sweep[str(b)] = dict(synced_ms_per_step=ms, frames_per_s=b * 1e3 / ms,
                             peak_mem_gib=out["peak_mem_gib"],
                             device_ops_per_step=prof_b.get("device_ops_per_step"),
                             device_busy_ms_per_step=prof_b.get("device_busy_ms_per_step"))
    others = {}
    for backend, kernel in (("pallas_fused", "fused_linearize"), ("pallas_mxu", "nn1_pruned_mxu")):
        out, _, _ = batched_drive(slice_config(backend), world, frames[:SHORT_FRAMES],
                                  f"{backend} B=4")
        require(out["launches"][kernel]["cuda"] > 0, f"batched {backend}: {kernel} never launched")
        others[backend] = out
    torch.cuda.empty_cache()
    shard = sharded_check(cfg, frames, results, snapshot, refine_graph)
    summary = dict(card=card, lanes=LANES, lane0_vs_single_max_m=lane_diff,
                   synced_ms_per_step_30_frames=main["synced_ms_per_step_median"],
                   host_reads_per_step_median=main["host_reads_per_step_median"],
                   device_ops_per_step=profile.get("device_ops_per_step"),
                   device_busy_ms_per_step=profile.get("device_busy_ms_per_step"),
                   prefix_scan_ms_per_step=profile.get("prefix_scan_ms_per_step"),
                   idle_share_profiled=profile.get("idle_share_profiled"), sweep=sweep)
    print(f"# batched summary {json.dumps(summary)}")
    return dict(main=main, profile=profile, sweep=sweep, others=others, sharded=shard,
                summary=summary)


def tensor_op_lanes(backend, world, frames, card, single_profile):
    """Phase 14, one backend: the batched drive at B = 4 over ``frames``,
    lane 0 against its single-sequence drive, no kernel and no plain
    version launched, host reads a step against the single drive's."""
    cfg = slice_config(backend)
    out, results, snapshot = batched_drive(cfg, world, frames, f"{backend} B={LANES}",
                                           snapshot_at=SHARDED_STEPS)
    for name, cnt in out["launches"].items():
        require(cnt["cuda"] == 0 and cnt["plain"] == 0,
                f"batched {backend}: {name} launched {cnt['cuda']} times, "
                f"its plain version {cnt['plain']}")
    single, single_kf, single_reads = single_lane_drive(cfg, frames)
    lane0 = torch.stack([r.pose[0] for r in results])
    lane_diff = float((lane0[:, :3, 3] - single[:, :3, 3]).abs().max())
    reads = out["host_reads_per_step"]
    summary = dict(
        backend=backend, card=card, lanes=LANES, frames=len(frames),
        lane0_vs_single_max_m=lane_diff, lane0_bitwise=bool(torch.equal(lane0, single)),
        lane0_keyframes=out["keyframes"][0], single_keyframes=single_kf,
        host_reads_per_step_median=float(np.median(reads)), host_reads_per_step_max=max(reads),
        single_reads_per_frame_median=float(np.median(single_reads)),
        single_reads_per_frame_max=max(single_reads),
        synced_ms_per_step_median=out["synced_ms_per_step_median"],
        frames_per_s=out["frames_per_s"], peak_mem_gib=out["peak_mem_gib"],
        single_frame_profile={k: single_profile.get(k) for k in (
            "device_ops_per_frame", "device_busy_ms_per_frame", "idle_share_profiled")},
    )
    print(f"# tensor-op lanes {json.dumps(summary)}")
    require(lane_diff <= LANE_POSE_TOL,
            f"batched {backend}: lane 0 is {lane_diff:.2e} m from its single-sequence drive")
    require(out["keyframes"][0] == single_kf,
            f"batched {backend}: lane 0 has {out['keyframes'][0]} keyframes, its single drive "
            f"{single_kf}")
    require(np.median(reads) <= np.median(single_reads) + 2 and max(reads) <= max(single_reads) + 2,
            f"batched {backend}: host reads a step {reads} against the single drive's "
            f"{single_reads}")
    return cfg, out, results, snapshot, summary


def tensor_op_batch_phase(world, lscans, card, single_profiles):
    """Phase 14: the batched step on "hashgrid" (BACKEND_FRAMES frames) and
    "brute" (BRUTE_BATCH_FRAMES) at B = 4 on phase 13's lanes, profiled
    steps (hashgrid at B = 1 and 4, brute at B = 4), then the NCCL
    world-size-1 sharded step on "hashgrid"."""
    dev = torch.device("cuda")
    frames = device_frames(lscans[:BACKEND_FRAMES], slice_config().shapes.n_raw, dev)
    hcfg, hout, hres, hsnap, hsum = tensor_op_lanes("hashgrid", world, frames, card,
                                                    single_profiles["hashgrid"])
    _, bout, _, _, bsum = tensor_op_lanes("brute", world, frames[:BRUTE_BATCH_FRAMES], card,
                                          single_profiles["brute"])
    profiles = {
        "hashgrid B=1": batched_profile(hcfg, [tuple(t[:1] for t in f) for f in frames]),
        f"hashgrid B={LANES}": batched_profile(hcfg, frames),
        f"brute B={LANES}": batched_profile(slice_config("brute"), frames[:BRUTE_BATCH_FRAMES],
                                            warmup=1, steps=2),
    }
    torch.cuda.empty_cache()
    shard = sharded_check(hcfg, frames, hres, hsnap, label="phase 14")
    keys = ("device_ops_per_step", "device_busy_ms_per_step", "idle_share_profiled",
            "profiled_wall_ms_per_step")
    summary = dict(card=card, hashgrid=hsum, brute=bsum,
                   profiles={k: {f: v.get(f) for f in keys} for k, v in profiles.items()})
    print(f"# tensor-op batched summary {json.dumps(summary)}")
    return dict(hashgrid=hout, brute=bout, profiles=profiles, sharded=shard, summary=summary)


def long_world():
    """Phase 15's scans: the closed loop with elevation of
    ``tools_torch/long_validation.py`` at LONG_FRAMES frames, rendered
    once (noise 0.01, no burst) at full width (OS1-64, 40 m)."""
    from tools_torch import long_validation as lv

    world, render = lv.make_world(LONG_FRAMES)
    return world, list(lv.render_scans(world, render, LONG_FRAMES, noise=0.01))


def long_config(ring: int | None = None):
    """The long-validation tool's configuration with loop closure on (512
    slots); with ``ring``, drive B's: ``ring`` slots and an 8-keyframe
    submap whose flat budget holds all 8 keyframes, as in the JAX tool's
    ``LV_MAX_KF`` regime."""
    from tools_torch import long_validation as lv

    cfg = lv.with_posegraph(lv.make_config(), True)
    if ring is not None:
        sh = cfg.shapes
        cfg = cfg.replace(shapes=dataclasses.replace(
            sh, max_keyframes=ring, max_submap_kf=LONG_SUBMAP_KF,
            n_submap_flat=LONG_SUBMAP_KF * sh.n_keyframe))
    return cfg


def long_drive(cfg, world, scans, label, device="cuda"):
    """Phase 15: one drive of ``tools_torch.long_validation.drive`` with every
    launch counter reset just before; prints its row, its rounds and its
    trigger checks, then holds the gates every drive shares: the ATE gate,
    S2M correspondences > 100 on every frame, every trigger check whose
    two gates pass runs its round (and no other does), the host reads of
    each frame without a round, finite state, K1 and K2 launched, no plain
    version. Returns (the printed summary, the drive's trace)."""
    from tools_torch import long_validation as lv

    reset_counters()
    row, tr = lv.drive(cfg, world, scans, device)
    launches = read_counters()
    del tr["runner"]  # free the drive's state before the next one
    cap = tr["capacity"]
    round_at = {e["index"] for e in tr["refine_log"] if not e["forced"]}
    checked = {c["frame"] for c in tr["checks"]}
    # every frame without a round reads what its step reads: one read per
    # GICP LM step, counted apart from the reads (1 to lm_max_iterations
    # steps an outer iteration, at least the reported S2S + S2M iterations:
    # the coarse stage and the rescue report none), and the fixed three; a
    # trigger check adds the runner's read of the keyframe count
    lm_max = max(cfg.gicp.s2s.lm_max_iterations, cfg.gicp.s2m.lm_max_iterations)
    quiet = [t for t in range(1, len(tr["host_reads"])) if t not in round_at]
    off = []
    for t in quiet:
        sites = dict(tr["reads_by_module"][t])
        lm, lin = sites.pop("gicp", 0), tr["linearizations"][t]
        expect = dict(STEP_FIXED_READS, **({"runner": 1} if t in checked else {}))
        reported = tr["s2s_iterations"][t] + tr["s2m_iterations"][t]
        if sites != expect or lm != tr["lm_steps"][t] or not reported <= lin <= lm <= lin * lm_max:
            off.append((t, tr["reads_by_module"][t], tr["linearizations"][t], tr["lm_steps"][t]))
    reads = [tr["host_reads"][t] for t in quiet]
    ms = tr["frame_ms"]
    full = row["ring_full_frame"]
    steady = [t for t in range(1 + WARMUP, len(ms)) if t not in round_at]
    before = [ms[t] for t in steady if full is None or t <= full]
    after = [ms[t] for t in steady if full is not None and t > full]
    rounds = [dict(frame=e["index"], forced=e["forced"], keyframes=e["n_keyframes"],
                   candidates=e["n_candidates"], accepted=e["n_accepted"],
                   graph_error=e["graph_error"], round_wall_ms=e["wall_ms"],
                   frame_ms=None if e["forced"] else ms[e["index"]])
              for e in tr["refine_log"]]
    corr = [c for c in tr["s2m_num_corr"] if c is not None]
    mem = dict(peak_frame50_mib=row["peak_mem_frame50_mib"], peak_end_mib=row["peak_mem_end_mib"],
               allocated_mib=tr["mem_current_mib"])
    out = dict(
        label=label, ring_slots=cap, submap_kf=cfg.shapes.max_submap_kf,
        submap_flat=cfg.shapes.n_submap_flat, row=row, rounds=rounds,
        checks=[dict(c) for c in tr["checks"]], min_s2m_num_corr=min(corr),
        host_reads_quiet_frames=dict(median=float(np.median(reads)), min=min(reads),
                                     max=max(reads)),
        gicp_lm_steps_quiet_frames=dict(
            median=float(np.median([tr["lm_steps"][t] for t in quiet])),
            min=min(tr["lm_steps"][t] for t in quiet), max=max(tr["lm_steps"][t] for t in quiet)),
        frames_off_the_step_reads=off,
        median_frame_ms=float(np.median([ms[t] for t in steady])),
        median_frame_ms_before_full=float(np.median(before)) if before else None,
        median_frame_ms_after_full=float(np.median(after)) if after else None,
        memory=mem, state_finite=tr["state_finite"], launches=launches,
    )
    print(f"# long drive {label} {json.dumps(out)}")
    for r in rounds:
        print(f"# long drive {label} round {json.dumps(r)}")
    gate = max(0.10, 0.001 * row["path_m"])
    require(row["ate_rmse_m"] <= gate,
            f"long drive {label}: ATE {row['ate_rmse_m']:.4f} m > {gate:.4f} m")
    require(min(corr) > 100, f"long drive {label}: a frame has s2m_num_corr {min(corr)} <= 100")
    for c in tr["checks"]:
        require(c["due"] == c["ran"], f"long drive {label}: trigger check {c} ran "
                                      f"{'a round it was not due' if c['ran'] else 'no round'}")
    require(not off, f"long drive {label}: frames without a round read more than their "
                     f"step and trigger: {off[:5]}")
    require(tr["state_finite"], f"long drive {label}: a state leaf is not finite")
    for name in ("nn1_pruned", "cov_pruned"):
        require(launches[name]["cuda"] > 0, f"long drive {label}: {name} was never launched")
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"long drive {label}: {name} plain version ran {cnt['plain']} times")
    return out, tr


def long_drive_phase(card, device="cuda"):
    """Phase 15: the long drive at full width on "pallas" past ring
    saturation, through ``tools_torch/long_validation.py``'s drive: A with
    the tool's 512-slot ring, B with LONG_RING slots (see the module
    docstring). Returns the K2 and K1 launches of both drives, and for each
    drive what phase 16 dissects: its configuration, the world, the copy
    of its state taken just before its forced round and that round's
    log entry."""
    t0 = time.perf_counter()
    world, scans = long_world()
    render_s = time.perf_counter() - t0
    print(f"# rendered {len(scans)} long-drive scans in {render_s:.1f} s "
          f"({len(scans) / render_s:.2f} scans/s on this host, "
          f"{int(np.mean([len(s) for s in scans]))} points mean)")

    cfg_a, cfg_b = long_config(), long_config(LONG_RING)
    a, tra = long_drive(cfg_a, world, scans, "A", device)
    ra = a["row"]
    mem_growth = (None if ra["peak_mem_end_mib"] is None
                  else ra["peak_mem_end_mib"] - ra["peak_mem_frame50_mib"])
    unforced_a = [r for r in a["rounds"] if not r["forced"]]
    require(len(unforced_a) >= 1, "long drive A: no unforced loop-closure round ran")
    require(mem_growth is not None and mem_growth <= LONG_MEM_GROWTH_MIB,
            f"long drive A: peak device memory grew {mem_growth} MiB from frame 50 to the end")

    b, trb = long_drive(cfg_b, world, scans, "B", device)
    rb = b["row"]
    require(rb["evictions"] >= 1, "long drive B: no keyframe was evicted")
    require(rb["keyframes"] == LONG_RING,
            f"long drive B: the ring holds {rb['keyframes']} keyframes, not {LONG_RING}")
    # every slot's seq is the frame of the last spawn written there, so the
    # seqs are distinct and follow spawn order after eviction
    last = {}
    for t, slot in enumerate(trb["kf_slot"]):
        if t == 0:
            last[0] = 0  # the init frame writes slot 0
        elif trb["new_keyframe"][t]:
            last[slot] = t
    expect = [last[s] for s in range(LONG_RING)]
    require(trb["seq"] == expect, f"long drive B: ring seq {trb['seq']} is not the spawn "
                                  f"frames {expect}")
    require(len(set(trb["seq"])) == LONG_RING, "long drive B: two slots share a seq")
    full = rb["ring_full_frame"]
    full_rounds = [r for r in b["rounds"] if not r["forced"] and r["keyframes"] == LONG_RING]
    require(full is not None, "long drive B: the ring never filled")
    require(len(full_rounds) <= 1,
            f"long drive B: {len(full_rounds)} unforced rounds ran with the ring full")
    if full_rounds:
        require(all(r["frame"] <= full_rounds[0]["frame"] for r in b["rounds"] if not r["forced"]),
                "long drive B: an unforced round ran after the one with the ring full")
    launches = {name: a["launches"][name]["cuda"] + b["launches"][name]["cuda"]
                for name in ("nn1_pruned", "cov_pruned")}
    summary = dict(card=card, frames=LONG_FRAMES, render_s=render_s, path_m=ra["path_m"],
                   ate_m={"A": ra["ate_rmse_m"], "B": rb["ate_rmse_m"]},
                   rounds={"A": len(a["rounds"]), "B": len(b["rounds"])},
                   evictions_b=rb["evictions"], ring_full_frame_b=full,
                   mem_growth_a_mib=mem_growth,
                   frame_ms_b_before_after_full=[b["median_frame_ms_before_full"],
                                                 b["median_frame_ms_after_full"]],
                   launches=launches)
    print(f"# long drive summary {json.dumps(summary)}")
    forced = {label: dict(cfg=c, world=world, state=tr["state_before_forced"],
                          round=tr["refine_log"][-1])
              for label, c, tr in (("A", cfg_a, tra), ("B", cfg_b, trb))}
    return launches, forced


def finite_rows(rows) -> bool:
    """Every number in a list of JSON rows (lists flattened) is finite."""
    values = [v for row in rows for v in row.values() if not isinstance(v, str)]
    flat = [x for v in values for x in (v if isinstance(v, list) else [v])]
    return all(np.isfinite(float(x)) for x in flat)


def no_plain(launches, what: str) -> None:
    for name, cnt in launches.items():
        require(cnt["plain"] == 0, f"{what}: {name} plain version ran {cnt['plain']} times")


def graft_entry_phase(card, forced):
    """Phase 16: ``graft_entry_torch.entry()``'s step on the card and
    ``dryrun_multichip(1)`` at NCCL world size 1 on a file store; the
    loop-closure dissection (``tools_torch/debug_loopclosure.dissect``) of
    phase 15's drive-A and drive-B states before their forced rounds and
    of the long-validation tool's small noise-burst drive at 24 slots,
    each equal to its round (candidates, accepted edges, the 8-iteration
    graph error bit for bit); ``tools_torch/scaling_bench.py`` at N = 1
    (its default batch and frames, one NCCL process). Counters are reset
    before each part. Returns the K2 and K1 launches of the entry step,
    the dry run and the dissections."""
    import graft_entry_torch
    from tools_torch import debug_loopclosure, scaling_bench

    launches = {}
    reset_counters()
    fn, args = graft_entry_torch.entry()
    _, res = fn(*args)
    torch.cuda.synchronize()
    launches["entry"] = read_counters()
    pose = res.pose.cpu().numpy()
    out = dict(card=card, entry=dict(position=pose[:3, 3].tolist(),
                                     s2m_num_corr=int(res.s2m_num_corr)))
    require(np.isfinite(pose).all(), "graft entry: the pose is not finite")
    for name in ("nn1_pruned", "cov_pruned"):
        require(launches["entry"][name]["cuda"] > 0, f"graft entry: {name} was never launched")
    no_plain(launches["entry"], "graft entry")

    import torch.distributed as dist

    reset_counters()
    graft_entry_torch.dryrun_multichip(1)
    launches["dryrun"] = read_counters()
    require(not dist.is_initialized(), "dryrun_multichip(1) left its group open")
    no_plain(launches["dryrun"], "dryrun_multichip(1)")
    out["dryrun"] = "ok"

    # the drive whose forced round made the keyframe map worse when the
    # tool ran alone: is it the loop measurements or the solver?
    from tools_torch import long_validation as lv

    cfg = lv.with_posegraph(lv.make_config(small=True, max_kf=SMALL_BURST_RING), True)
    world, render = lv.make_world(SMALL_BURST_FRAMES, small=True)
    row, tr = lv.drive(cfg, world, lv.render_scans(world, render, SMALL_BURST_FRAMES, 0.01,
                                                   SMALL_BURST), "cuda")
    del tr["runner"]
    print(f"# small burst drive {json.dumps(row)}")
    forced = dict(forced, small_burst=dict(cfg=cfg, world=world, state=tr["state_before_forced"],
                                           round=tr["refine_log"][-1]))

    for label, f in forced.items():
        reset_counters()
        t0 = time.perf_counter()
        d = debug_loopclosure.dissect(f["cfg"], f["state"], f["world"], "cuda")
        launches[f"dissect {label}"] = read_counters()
        rnd = f["round"]
        summary = dict(seconds=time.perf_counter() - t0, n_candidates=d["n_candidates"],
                       n_accepted=d["n_accepted"], round_candidates=rnd["n_candidates"],
                       round_accepted=rnd["n_accepted"],
                       graph_error_8=d["refine"][1]["graph_error"],
                       round_graph_error=rnd["graph_error"])
        print(f"# dissection {label} {json.dumps(summary)}")
        for row in debug_loopclosure.rows(d):
            print(f"# dissection {label} row {json.dumps(row)}")
        out[f"dissect_{label}"] = summary
        require((d["n_candidates"], d["n_accepted"]) == (rnd["n_candidates"], rnd["n_accepted"]),
                f"dissection {label}: {d['n_candidates']} candidates, {d['n_accepted']} accepted; "
                f"the forced round had {rnd['n_candidates']}, {rnd['n_accepted']}")
        require(d["refine"][1]["iters"] == f["cfg"].posegraph.iterations
                and d["refine"][1]["graph_error"] == rnd["graph_error"],
                f"dissection {label}: graph error {d['refine'][1]['graph_error']!r} at 8 "
                f"iterations, the forced round's {rnd['graph_error']!r}")
        require(finite_rows(debug_loopclosure.rows(d)), f"dissection {label}: a row is not finite")
        require(launches[f"dissect {label}"]["nn1_pruned"]["cuda"] > 0,
                f"dissection {label}: nn1_pruned was never launched")
        no_plain(launches[f"dissect {label}"], f"dissection {label}")

    t0 = time.perf_counter()
    rows = scaling_bench.run(sizes=[1], device="cuda")
    for row in rows:
        print(f"# scaling_bench {json.dumps(row)}")
    fps = rows[0]["aggregate_fps"]
    require(np.isfinite(fps) and fps > 0, f"scaling_bench N = 1: aggregate fps {fps}")
    out["scaling_bench"] = dict(rows[0], seconds=time.perf_counter() - t0)
    print(f"# graft entry summary {json.dumps(out)}")
    return {name: {part: cnt[name]["cuda"] for part, cnt in launches.items()}
            for name in ("nn1_pruned", "cov_pruned")}


def stage_tools_phase(card, phase4_profile):
    """Phase 17: the stage-attribution tools (``tools_torch/profile_stages``,
    ``ablate_step``, ``micro_align``, ``micro_linearize``) through their
    ``run`` at their production shapes on "pallas", STAGE_REPS timed calls
    a row (the tools' own defaults: 8, 16, 20 and 16). Every row printed;
    gates: every time finite and > 0, no plain version launched by any
    row, K1 launched by the normals and by the keyframe spawn exactly when
    it spawns, K2 by the S2S and S2M stages, K3 by the fused
    linearizations, and the full prefix equal to ``odom_frame`` bit for
    bit (pose, keyframe decision, count). Printed without a gate: the
    ablation's deltas against its ``odom_frame`` row, and each stage's
    device operations beside phase 4's frame. Returns the K1-K3 launches
    of the rows' counted calls."""
    from tools_torch import ablate_step, micro_align, micro_linearize, profile_stages

    t0 = time.perf_counter()
    tools = {
        "profile_stages": profile_stages.run(n=STAGE_REPS),
        "ablate_step": ablate_step.run(n=STAGE_REPS),
        "micro_align": micro_align.run(n=STAGE_REPS),
        "micro_linearize": micro_linearize.run(n=STAGE_REPS),
    }
    for tool, rows in tools.items():
        for row in rows:
            print(f"# {tool} row {json.dumps(row)}")

    def by_name(rows, key="stage"):
        return {r[key]: r for r in rows}

    def launched(row, kernel):
        return row["launches"][kernel]["cuda"]

    for tool, rows in tools.items():
        for row in rows:
            name = row.get("stage", row.get("stop"))
            times = [row["ms"]] + ([row["cum_ms"]] if "cum_ms" in row else [])
            require(all(np.isfinite(t) and t > 0 for t in times),
                    f"phase 17 {tool} {name}: times {times}")
            require(all(np.isfinite(v) for v in (row["device_ops"], row["busy_ms"])),
                    f"phase 17 {tool} {name}: no device trace")
            for kernel, cnt in row["launches"].items():
                require(cnt["plain"] == 0, f"phase 17 {tool} {name}: {kernel}'s plain version ran")
    ps = by_name(tools["profile_stages"])
    require(launched(ps["normals"], "K1") > 0, "phase 17 profile_stages: normals without K1")
    kf = ps["keyframe maybe_spawn"]
    require((launched(kf, "K1") > 0) == kf["spawned"],
            f"phase 17 keyframe maybe_spawn: spawned {kf['spawned']}, K1 {launched(kf, 'K1')}")
    for name in ("s2s align", "s2m align", "FULL step (odom_frame)"):
        require(launched(ps[name], "K2") > 0, f"phase 17 profile_stages: {name} without K2")
    ab = by_name(tools["ablate_step"], "stop")
    names = list(ab)  # dispatch floor, the stops, odom_frame
    for stop in names[names.index("normals"):]:
        require(launched(ab[stop], "K1") > 0, f"phase 17 ablate_step {stop}: no K1")
    for stop in names[names.index("normals") + 1:]:
        require(launched(ab[stop], "K2") > 0, f"phase 17 ablate_step {stop}: no K2")
    match = ab["odom_frame"]["full_matches_step"]
    require(match["pose_equal"] and match["new_keyframe_equal"] and match["count_equal"],
            f"phase 17: the full prefix differs from odom_frame: {match}")
    ma = by_name(tools["micro_align"])
    for name in ("pallas 1nn only", "update_correspondences", "full _linearize",
                 "align (s2s, ~3 iters)", "s2m align", "FULL odom_frame"):
        require(launched(ma[name], "K2") > 0, f"phase 17 micro_align: {name} without K2")
    require(launched(ma["scan normals"], "K1") > 0, "phase 17 micro_align: normals without K1")
    ml = by_name(tools["micro_linearize"])
    for name in ("_linearize fused cold", "_linearize fused seeded"):
        require(launched(ml[name], "K3") > 0, f"phase 17 micro_linearize: {name} without K3")
    for name in ("NN kernel alone", "_linearize unfused"):
        require(launched(ml[name], "K2") > 0, f"phase 17 micro_linearize: {name} without K2")

    stops = [r for r in tools["ablate_step"] if r["stop"] not in ("dispatch floor", "odom_frame")]
    summary = dict(
        card=card, seconds=time.perf_counter() - t0, reps=STAGE_REPS,
        ablate_delta_sum_ms=sum(r["delta_ms"] for r in stops),
        ablate_odom_frame_ms=ab["odom_frame"]["cum_ms"], full_matches_step=match,
        stage_device_ops={name: r["device_ops"] for name, r in ps.items()},
        stage_device_ops_sum=sum(r["device_ops"] for name, r in ps.items()
                                 if name != "FULL step (odom_frame)"),
        phase4_device_ops_per_frame=phase4_profile["device_ops_per_frame"],
        phase4_busy_ms_per_frame=phase4_profile.get("device_busy_ms_per_frame"),
        # the profiler's dropped records, counted on the spins around each call
        pad_records_lost={tool: [r["pad_records_lost"] for r in rows]
                          for tool, rows in tools.items()})
    print(f"# stage tools summary {json.dumps(summary)}")
    counted = {k: 0 for k in ("K1", "K2", "K3")}
    for rows in tools.values():
        for row in rows:
            for k in counted:
                counted[k] += launched(row, k)
    return counted


def bench_phase(card):
    """Phase 18: ``bench_torch.main`` in process, four calls (the module
    docstring's list), counters reset before each; each call's line, its
    seconds and its launches printed. Returns each call's launches."""
    import bench_torch

    t0 = time.perf_counter()
    calls = {
        "default": [],
        "batch 4": ["--batch", "4", "--frames", "24"],
        "imu": ["--imu", "--no-loop"],
        "pallas_fused": ["--set", "nn_backend=pallas_fused", "--no-loop", "--frames", "45"],
    }
    lines, launches, trajs, seconds = {}, {}, {}, {}
    for name, argv in calls.items():
        reset_counters()
        t = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            lines[name] = bench_torch.main(argv, trajectories=trajs if name == "default" else None)
        launches[name] = read_counters()
        seconds[name] = time.perf_counter() - t
        print(f"# bench {name} ({seconds[name]:.1f} s) line {stdout.getvalue().strip()}")
        print(f"# bench {name} launches {json.dumps(launches[name])}")
        require("error" not in lines[name], f"phase 18 {name}: {lines[name].get('error')}")
        for kernel, cnt in launches[name].items():
            require(cnt["plain"] == 0, f"phase 18 {name}: {kernel}'s plain version ran")
    for name in ("default", "imu", "pallas_fused"):
        line = lines[name]
        require(line["ate_rmse_m"] <= line["gate_m"] and line["value"] > 0,
                f"phase 18 {name}: ATE {line['ate_rmse_m']} m (gate {line['gate_m']}), "
                f"{line['value']} frames/s")
    default = lines["default"]
    require(default.get("stream_fps", 0) > 0, f"phase 18: streamed {default.get('stream_fps')}")
    loop = default["loopclosure"]
    require(loop["loop_edges"] >= 1 and loop["kf_map_err_after_m"] < loop["kf_map_err_before_m"],
            f"phase 18 loop closure: {loop}")
    for name in ("default", "batch 4"):
        for kernel in ("nn1_pruned", "cov_pruned"):
            require(launches[name][kernel]["cuda"] > 0, f"phase 18 {name}: {kernel} not launched")
    require(lines["batch 4"]["value"] > 0, f"phase 18 batch 4: {lines['batch 4']}")
    require(launches["pallas_fused"]["fused_linearize"]["cuda"] > 0,
            "phase 18 pallas_fused: fused_linearize not launched")
    ref = trajs["pass 1"]
    passes = {}
    for name in ("pass 2", "pass 3", "stream"):
        est = trajs[name]
        require(est.shape == ref.shape, f"phase 18: {name} has {len(est)} poses, pass 1 {len(ref)}")
        dev = float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max())
        passes[name] = dict(max_dev_m=dev, bitwise=bool(np.array_equal(est, ref)))
        require(dev <= BENCH_POSE_TOL, f"phase 18: {name} deviates {dev} m from pass 1")
    summary = dict(card=card, seconds=time.perf_counter() - t0, call_seconds=seconds,
                   passes_vs_pass1=passes)
    print(f"# bench summary {json.dumps(summary)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from direct_lidar_odometry_tpu_torch.ops import cuda_build

    _, build_s = cuda_build.build()
    cuda_build.library()
    print(f"# kernels built in {build_s:.1f} s from {[p.name for p in cuda_build.sources()]}")
    from direct_lidar_odometry_tpu_torch.io import native

    # the host library: the wire encoder of every phase, phase 10's host
    # preprocessing (a failed build raises with g++'s message)
    _, host_build_s = native.build()
    print(f"# native host library built in {host_build_s:.2f} s from {native.SOURCE.name}")

    cfg = slice_config()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    world, scans = make_world()
    print(f"# rendered {len(scans)} scans in {time.perf_counter() - t0:.1f} s "
          f"({int(np.mean([len(s) for s in scans]))} points mean)")

    from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32

    pin_float32()
    inp = kernel_inputs(cfg, world, scans, dev)
    # the library yardstick of K2 and K4 at S2M r 0.5, the kernels line's shape
    k2 = [check_k2(inp.queries, inp.submap, r, "S2M", library=r == 0.5) for r in (0.5, 1.0, 1.5)]
    k2.append(check_k2(inp.queries, inp.s2s, 1.0, "S2S"))
    k2.append(check_k2(inp.edge_src, inp.edge_tgt, cfg.posegraph.loop_corr_distance, "loop edge"))
    k4 = [check_k4(inp.queries, inp.submap, r, library=r == 0.5) for r in (0.5, 1.0, 1.5)]
    k1 = [check_k1(inp.scan0, 0.75, "scan"), check_k1(inp.kf0, 1.5, "keyframe")]
    k3 = [check_k3(inp.queries, inp.submap, 0.5, "S2M"), check_k3(inp.queries, inp.s2s, 1.0, "S2S")]
    k5, k6 = check_exhaustive(inp, scans, dev)
    t0 = time.perf_counter()
    lscans = lane_scans(world, N_FRAMES)
    print(f"# rendered {LANES} lanes x {N_FRAMES} scans in {time.perf_counter() - t0:.1f} s")
    lanes = check_lanes(lane_kernel_inputs(cfg, world, lscans, dev))

    phase_s, clock = {}, [t_start]

    def timed_phase(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"# phase {name} took {phase_s[name]:.1f} s")

    timed_phase("1-3")
    main_path, runner = drive(cfg, world, scans)
    profiles = {backend: device_ops_per_frame(slice_config(backend), world, scans)
                for backend in BACKENDS}
    timed_phase(4)
    cli_fused = drive_cli("pallas_fused", world)
    cli_mxu = drive_cli("pallas_mxu", world)
    timed_phase(5)
    oracle = oracle_check(cfg, runner)
    timed_phase(6)

    t0 = time.perf_counter()
    loop_w, loop_scans = loop_world(cfg.shapes.n_raw)
    print(f"# rendered {len(loop_scans)} loop-world scans in {time.perf_counter() - t0:.1f} s")
    from direct_lidar_odometry_tpu_torch.config import load_config

    loop, loop_graph = loop_closure_check(loop_config(load_config(str(CFG_PATH))), loop_w,
                                          loop_scans)
    timed_phase(7)
    imu_chunk_check(cfg, loop_w, loop_scans[:IMU_FRAMES])
    timed_phase(8)
    host = host_preprocess_check(world, scans, main_path, runner, profiles["pallas"], host_build_s)
    timed_phase(10)
    kitti = intensity_cli_check(world)
    timed_phase(11)
    op_profiles = {}
    for backend in ("brute", "hashgrid"):
        backend_check(backend, world, scans, smi)
        op_profiles[backend] = device_ops_per_frame(slice_config(backend), world, scans)
    timed_phase(12)
    batch = batch_phase(world, lscans, loop_graph, smi)
    timed_phase(13)
    tensor_op_batch_phase(world, lscans, smi, op_profiles)
    timed_phase(14)
    long_launches, forced = long_drive_phase(smi)
    timed_phase(15)
    entry_launches = graft_entry_phase(smi, forced)
    del forced
    timed_phase(16)
    stage_launches = stage_tools_phase(smi, profiles["pallas"])
    timed_phase(17)
    bench_launches = bench_phase(smi)
    timed_phase(18)
    print(f"# phase seconds {json.dumps(phase_s)}, total {time.perf_counter() - t_start:.1f}")

    batched_launches = {name: batch["main"]["launches"][name]["cuda"]
                        for name in ("nn1_pruned", "cov_pruned")}
    batched_launches["fused_linearize"] = \
        batch["others"]["pallas_fused"]["launches"]["fused_linearize"]["cuda"]
    batched_launches["nn1_pruned_mxu"] = \
        batch["others"]["pallas_mxu"]["launches"]["nn1_pruned_mxu"]["cuda"]
    lane_key = {"nn1_pruned": "K2", "cov_pruned": "K1", "fused_linearize": "K3",
                "nn1_pruned_mxu": "K4"}

    def entry(name, src, replaces, path, launches, cases):
        out = dict(name=name, route="cuda", source=f"direct_lidar_odometry_tpu_torch/csrc/{src}",
                   replaces=f"direct_lidar_odometry_tpu/ops/{replaces}", path=path,
                   launches=launches[name]["cuda"],
                   max_abs_err=max(c["max_abs_err"] for c in cases),
                   ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
                   bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"],
                   library_ms=cases[0]["library_ms"],
                   batched_launches=batched_launches.get(name, 0))
        if name in lane_key:
            out["lane_ms"] = {b: c["ms"] for b, c in lanes[lane_key[name]]["sweep"].items()}
            out["lane_bound_ms"] = {b: c["bound_ms"]
                                    for b, c in lanes[lane_key[name]]["sweep"].items()}
        return out

    def host_paths(name):
        cli_launches = sum(run["launches"][name]["cuda"] for run in kitti.values())
        return (f"; host preprocessing ({host['drive']['launches'][name]['cuda']} launches); "
                f"KITTI cli, xyzi and feeder ({cli_launches} launches); long drive past ring "
                f"saturation (phase 15, drives A and B: {long_launches[name]} launches); "
                f"phase 16: graft entry step, sharded dry run, loop-closure dissections of "
                f"drives A, B and the small noise-burst drive "
                f"({json.dumps(entry_launches[name])} launches)" + stage_path(name))

    def stage_path(name):
        bench = {call: cnt[name]["cuda"] for call, cnt in bench_launches.items()}
        return (f"; phase 17: the stage tools' rows (profile_stages, ablate_step, micro_align, "
                f"micro_linearize: {stage_launches[stage_key[name]]} launches); phase 18: "
                f"bench_torch ({json.dumps(bench)} launches)")

    stage_key = {"nn1_pruned": "K2", "cov_pruned": "K1", "fused_linearize": "K3"}

    kernels = [
        entry("nn1_pruned", "nn1_pruned.cu", "pallas_nn.py:192",
              f"runner, pallas; loop closure (forced round: "
              f"{loop['refine_launches']['nn1_pruned']['cuda']} launches)" + host_paths("nn1_pruned"),
              main_path["launches"], k2),
        entry("cov_pruned", "cov_pruned.cu", "pallas_cov.py:117",
              "runner, pallas" + host_paths("cov_pruned"), main_path["launches"], k1),
        entry("fused_linearize", "fused_linearize.cu", "pallas_gicp.py:68",
              "cli, pallas_fused" + stage_path("fused_linearize"), cli_fused["launches"], k3),
        entry("nn1_pruned_mxu", "nn1_pruned.cu", "pallas_nn.py:200", "cli, pallas_mxu",
              cli_mxu["launches"], k4),
        entry("nn1_exhaustive", "nn1_exhaustive.cu", "pallas_nn.py:38",
              "oracle: query_1nn", oracle["launches"], k5),
        entry("cov_exhaustive", "cov_exhaustive.cu", "pallas_cov.py:40",
              "oracle: estimate_normals_radius", oracle["launches"], k6),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
