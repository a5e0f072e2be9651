"""End-to-end bench of the PyTorch/CUDA port: odometry frames/s on one card.

Port of the JAX package's ``bench.py``. Prints ONE JSON line on stdout,
with ``bench.py``'s keys:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
naming its measurement protocol and estimator; progress lines go to stderr
behind ``#``. :func:`main` also returns the line as a dict.

    python3 bench_torch.py [--frames N] [--small] [--cpu] [--batch B] [--chunk K]
                           [--inflight D] [--stream] [--loop] [--loop-frames N]
                           [--loop-ring S] [--no-loop] [--imu] [--dyn N]
                           [--set KEY=VAL ...]

The world is ``bench.py``'s: a campus corridor ray-cast through an OS1-64
beam model (``synthetic.make_urban_world``), 93 frames by default, every
scan rendered before the clock. Protocol: 5 synced warm-up frames, one
``process_chunk`` of the first chunk, the measured loop
(:func:`measured_loop`), the ATE gate max(0.10 m, 0.001 x path) scored
before any re-stepping, then (offline mode) the median of 3 passes each on
a fresh runner, the best of 3 synced chunks, one synced single-frame
latency, a streamed pass on a fresh runner, and the loop-closure check
(:func:`loop_closure_check`) unless ``--no-loop``, ``--small`` or
``--cpu``. ``--batch B`` measures B sequences in lock-step instead
(:func:`run_batched`); ``--loop`` runs only the loop-closure check.

Where the port differs from ``bench.py``:

- Device. Without ``--cpu`` the bench runs on the card and raises when
  there is none; it never moves to the CPU by itself. With ``--cpu`` the
  backend "auto" resolves to "pallas" with the kernels' plain versions
  (``config.resolve_backend``), not to "hashgrid".
- No background precompile: the warm-up frames absorb the kernels' build at
  first use, and the cold-start line reports that time.
- ``process_chunk`` is a host loop over the per-frame step that reads GICP
  flags on the host, so the pre-staged protocol's "no intermediate syncs"
  holds only for the bench's own reads.
- Failures are not swallowed: a failing loop-closure check fails the run,
  and a trajectory outside the ATE gate prints the "diverged" line and the
  script exits with code 1.
- The denominator. ``DLO_CPU_FPS_2CORE`` and ``DLO_CPU_ATE_M`` are
  ``tools_torch/run_baseline.py --frames 93 --threads 2`` (the C++/OpenMP
  reproduction of the reference, ``cpp/dlo_baseline.cpp``) on the card's
  own host, and ``DLO_CPU_FPS`` the same at ``--threads 8`` (the 8-core
  desktop class the reference targets), measured rather than extrapolated.
  The voxeled scans (~9-13k points) sit below the pipeline's n_scan budget,
  so neither side thins and ``vs_baseline_same_work`` equals
  ``vs_baseline``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch import config as config_mod
from direct_lidar_odometry_tpu_torch.cli import _parse_override
from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu_torch.io import evaluation, synthetic
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.parallel import batched
from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device
from tools_torch.long_validation import SMALL_SHAPES

# tools_torch/run_baseline.py --frames 93 on the host of an NVIDIA H100 80GB
# HBM3 at 700.00 W (nvidia-smi): 8 cores of a GenuineIntel CPU, family 6
# model 207 (lscpu reports no model name). Medians of the runs in PERF.md §5,
# "CPU denominator": 20.56-24.76 fps over 5 runs at 2 threads, 35.86-45.83
# over 6 at 8 threads, ATE 0.0168 m in each.
DLO_CPU_FPS_2CORE = 22.64  # --threads 2
DLO_CPU_ATE_M = 0.0168
DLO_CPU_FPS = 39.79  # --threads 8 (the middle two runs: 38.15 and 41.42)
WARMUP = 5  # synced frames before the first chunk


def production_cfg(small: bool = False) -> DloConfig:
    """``bench.py``'s operating point: coarse-only S2S at stride 8, host
    preprocessing, a 12288-point scan (the voxeled scan is ~9-13k points,
    so it rarely thins), a 16384-point submap, a 128-slot ring; ``small``
    swaps in the small shapes (64-slot ring)."""
    base = DloConfig()
    base = base.replace(
        s2s_prior="constant_velocity",
        host_preprocess=True,
        gicp=dataclasses.replace(base.gicp, s2s_full_polish=False, s2s_coarse_stride=8),
        shapes=dataclasses.replace(base.shapes, n_scan=12288, n_submap_flat=16384,
                                   max_keyframes=128),
    )
    if small:
        return base.replace(shapes=ShapeConfig(max_keyframes=64, **SMALL_SHAPES))
    return base


def with_overrides(cfg: DloConfig, overrides) -> DloConfig:
    """``cfg`` with each "dotted.key=value" string applied in order, as the
    CLI's ``--set``."""
    for kv in overrides:
        key, value = _parse_override(kv)
        cfg = config_mod._override(cfg, key.split("."), value)
    return cfg


def make_bench_world(n_frames: int, rng: np.random.Generator, small: bool,
                     n_dynamic: int | None = None):
    """``bench.py``'s world: (world, max_range, max_points, beams). The
    campus-corridor BoxWorld, ray-cast through an OS1-64 beam model (64 x
    1024, 40 m; small: 32 x 512 beams, 13 m), with ``n_dynamic`` moving
    boxes (None: the world's default, 1 small, max(2, n_frames // 25))."""
    if small:
        world = synthetic.make_urban_world(
            rng, n_frames=n_frames, speed=0.4, corridor=7.0,
            n_dynamic=1 if n_dynamic is None else n_dynamic)
        return world, 13.0, 8192, synthetic.BeamModel(n_beams=32, n_azimuth=512)
    world = synthetic.make_urban_world(
        rng, n_frames=n_frames, speed=1.0,
        n_dynamic=max(2, n_frames // 25) if n_dynamic is None else n_dynamic)
    return world, 40.0, 131072, synthetic.BeamModel()


def push_imu(runner: OdometryRunner, world, n_frames: int) -> int:
    """Push the synthesized 100 Hz gyro between every pair of the first
    ``n_frames`` frames into ``runner`` (rows from ``rng(7)``, as
    ``bench.py``); returns the sample count."""
    imu_rng = np.random.default_rng(7)
    n = 0
    for t in range(1, n_frames):
        for row in synthetic.make_imu_between(world, t, 100.0, imu_rng):
            runner.push_imu(float(row[0]), row[1:4], row[4:7])
            n += 1
    return n


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(args) -> torch.device:
    return torch.device("cpu") if args.cpu else require_device("cuda")


def run_batched(args) -> dict:
    """Aggregate multi-sequence throughput on one card: ``args.batch``
    sequences in lock-step through ``parallel/batched.py`` (which feeds raw
    scans: host preprocessing is off there). Lane i of frame t is
    ``render_scan(world, t, rng(100 + i))``; every frame is rendered and
    copied to the device before the clock, which starts at step 4. Two
    steps stay in flight: after each step the previous step's positions
    are read to the host, and the estimator is the median interval."""
    dev = _device(args)
    cfg = with_overrides(production_cfg(args.small), args.set)
    b = args.batch
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(args.frames, rng, args.small)
    init_fn, step_fn = batched.make_batched_fns(cfg)
    states = batched.batched_state(cfg, b, device=dev)

    t0 = time.perf_counter()
    frames_data = []
    for t in range(args.frames):
        pts = np.full((b, cfg.shapes.n_raw, 3), 1e6, np.float32)
        mask = np.zeros((b, cfg.shapes.n_raw), bool)
        for i in range(b):
            s = synthetic.render_scan(world, t, np.random.default_rng(100 + i),
                                      max_range=max_range, max_points=max_pts, beams=beams)
            pts[i, : len(s)] = s
            mask[i, : len(s)] = True
        frames_data.append((torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)))
    _sync(dev)
    print(f"# rendered {b} lanes x {args.frames} scans in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)

    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4).contiguous()
    states = init_fn(states, *frames_data[0])
    times = []
    pending = None
    last = None
    for t in range(1, args.frames):
        if t == 4:  # after the warm-up steps
            last = time.perf_counter()
        states, res = step_fn(states, *frames_data[t], eye)
        if pending is not None and last is not None:
            pending.position.cpu()
            now = time.perf_counter()
            times.append(now - last)
            last = now
        pending = res
    pending.position.cpu()
    med = float(np.median(times))
    fps = b / med
    print(f"# batched B={b}: {med * 1e3:.1f} ms/step median, {len(times)} intervals",
          file=sys.stderr)
    return {
        "metric": "odometry_frames_per_s_per_chip_batched",
        "value": round(fps, 2), "unit": "frames/s",
        "vs_baseline": round(fps / DLO_CPU_FPS, 3),
    }


def loop_closure_check(cfg: DloConfig, frames: int = 144, ring: int | None = None,
                       per_frame_detail: bool = False, device="cuda") -> dict:
    """Loop-closure repair measured on the card.

    A closed-loop ray-cast world (``rng(21)``, no moving boxes); frames
    [40, 80) render degraded (11 m range, 0.35 m range noise: odometry
    drifts through them and carries the error to the revisit); pose-graph
    refinement on with ``loop_radius`` 12 m (the last keyframe spawns ~9 m
    short of closing the circle), ``min_index_gap`` 12, a trigger check
    every 48 frames and a round every 8 keyframes; ``ring`` sets the
    keyframe ring's slots. After the drive a forced round runs, timed with
    a device sync on both sides. The metric is the keyframe-map error: the
    mean distance of each keyframe to its OWN ground-truth pose (through
    the ring's ``seq``); past trajectory poses are already emitted, so the
    end ATE cannot see a final refinement, while the re-anchored ring can.
    ``per_frame_detail`` adds the forced round's diagnostics."""
    dev = require_device(device)
    cfg = cfg.replace(posegraph=dataclasses.replace(
        cfg.posegraph, use=True, min_index_gap=12, loop_radius=12.0, check_every=48,
        refine_every_kf=8))
    if ring:
        cfg = cfg.replace(shapes=dataclasses.replace(cfg.shapes, max_keyframes=ring))
    world = synthetic.make_urban_world(np.random.default_rng(21), n_frames=frames, speed=1.0,
                                       closed_loop=True, n_dynamic=0)
    beams = synthetic.BeamModel()
    runner = OdometryRunner(cfg, device=dev)
    srng = np.random.default_rng(5)
    for t in range(frames):
        burst = 40 <= t < 80
        scan = synthetic.render_scan(world, t, srng, max_range=11.0 if burst else 40.0,
                                     max_points=cfg.shapes.n_raw,
                                     noise=0.35 if burst else 0.01, beams=beams)
        runner.process_scan(scan, float(world.stamps[t]))
    gt_pos = (np.linalg.inv(world.poses[0])[None] @ world.poses)[:, :3, 3]

    def kf_map_error() -> float:
        kf = runner.state.keyframes
        kfc = int(kf.count)
        pos = kf.positions[:kfc].cpu().numpy()
        return float(np.linalg.norm(pos - gt_pos[kf.seq[:kfc].cpu().numpy()], axis=-1).mean())

    before = kf_map_error()
    rounds_before = len(runner.refine_log)
    _sync(dev)
    t0 = time.perf_counter()
    info = runner.maybe_refine(force=True)
    _sync(dev)
    refine_ms = (time.perf_counter() - t0) * 1e3
    after = kf_map_error()
    print(f"# loop closure: {rounds_before} rounds in the drive before the forced one",
          file=sys.stderr)
    out = {
        "frames": frames,
        "ring_slots": int(cfg.shapes.max_keyframes),
        "keyframes": runner.num_keyframes(),
        "loop_edges": sum(e["n_accepted"] for e in runner.refine_log),
        "refine_rounds": len(runner.refine_log),
        "kf_map_err_before_m": round(before, 4),
        "kf_map_err_after_m": round(after, 4),
        "forced_refine_wall_ms": round(refine_ms, 1),
    }
    if per_frame_detail and info is not None:
        out["last_refine"] = {k: round(float(v), 4) if hasattr(v, "__float__") else v
                              for k, v in info.items()}
    return out


def measured_loop(runner: OdometryRunner, scans, stamps, start: int, chunk: int,
                  stream: bool, inflight: int, executor: ThreadPoolExecutor) -> dict:
    """The steady-state loop over ``scans[start:]`` through ``runner``, in
    chunks of ``chunk`` frames (a tail shorter than a chunk, and every frame
    when ``chunk`` is 1, goes through ``process_scan``). Returns
    ``wall_ms`` (ms a frame over the window), ``n`` (frames) and, with
    ``stream`` and at least 3 timed chunks, ``median_ms``.

    Pre-staged protocol (``stream`` False, offline throughput): every
    chunk is encoded and copied to the device before the clock
    (``prepare_chunk``, then a device sync); the chunks are then enqueued
    back to back and the result is read once at the end. Estimator: the
    wall average.

    Stream protocol (online): ``executor`` (one thread) prepares each chunk
    just in time on the caller's CUDA stream, ``inflight`` chunks deep; the
    oldest result's positions are read each time, and the median chunk
    interval is the estimator (the first interval, which spans the
    pipeline fill, is dropped).

    The garbage collector is off inside the window.
    """
    n_chunks = max(0, (len(scans) - start) // chunk)
    staged: dict[int, list] = {}
    if chunk > 1 and not stream:
        ts = time.perf_counter()
        for t in range(start, start + n_chunks * chunk, chunk):
            staged[t] = runner.prepare_chunk(scans[t: t + chunk])
        _sync(runner.device)
        print(f"# pre-staged {len(staged)} chunks in {time.perf_counter() - ts:.1f} s",
              file=sys.stderr)
    # the worker thread prepares on the stream the steps run on
    cuda_stream = (torch.cuda.current_stream(runner.device)
                   if runner.device.type == "cuda" else None)

    def prepare(t: int):
        with torch.cuda.stream(cuda_stream):
            return runner.prepare_chunk(scans[t: t + chunk])

    # leave >= 3 timed chunks after the dropped pipeline-fill interval
    depth = max(1, min(inflight, n_chunks - 4))
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        res = None
        pending: list = []  # oldest first
        chunk_times: list[float] = []
        last_sync = t0
        t = start
        prep = (executor.submit(prepare, start)
                if chunk > 1 and stream and start + chunk <= len(scans) else None)
        while t < len(scans):
            if chunk > 1 and t + chunk <= len(scans):
                if staged:
                    prepared = staged.pop(t)
                else:
                    prepared = prep.result()
                    nxt = t + chunk
                    prep = executor.submit(prepare, nxt) if nxt + chunk <= len(scans) else None
                res = runner.process_chunk(scans[t: t + chunk], stamps[t: t + chunk],
                                           prepared=prepared)
                t += chunk
                pending.append(res)
                if stream and len(pending) > depth:
                    pending.pop(0).position.cpu()
                    now = time.perf_counter()
                    if last_sync != t0:  # the first pop spans the pipeline fill
                        chunk_times.append(now - last_sync)
                    last_sync = now
            else:
                res = runner.process_scan(scans[t], stamps[t], sync=(chunk == 1 and t % 8 == 0))
                t += 1
        t_enq = time.perf_counter() - t0
        pending.clear()
        if res is not None:
            # the device runs in order: one read covers every queued chunk
            res.position.cpu()
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    print(f"# loop phases: enqueue {t_enq * 1e3:.0f} ms, drain {(wall - t_enq) * 1e3:.0f} ms",
          file=sys.stderr)
    n_steady = len(scans) - start
    out = {"wall_ms": wall / max(n_steady, 1) * 1e3, "n": n_steady}
    if chunk_times:
        print(("# stream " if stream else "# ") + "chunk times (ms/frame): "
              + " ".join(f"{c / chunk * 1e3:.1f}" for c in chunk_times), file=sys.stderr)
        if len(chunk_times) >= 3:
            out["median_ms"] = float(np.median(chunk_times)) / chunk * 1e3
    return out


def gicp_iterations(result):
    """S2S + S2M GICP iterations of a frame result (a list for a stacked
    chunk result)."""
    if isinstance(result.s2s_iterations, list):
        return [a + b for a, b in zip(result.s2s_iterations, result.s2m_iterations)]
    return result.s2s_iterations + result.s2m_iterations


def prime(runner: OdometryRunner, scans, stamps, chunk: int) -> tuple[int, list[float]]:
    """The protocol's lead-in on ``runner``: WARMUP synced frames, then one
    ``process_chunk`` of the next ``chunk`` frames when more than a chunk
    follows. Returns (first frame of the measured loop, the warm-up
    frames' synced seconds, then the chunk's)."""
    secs = []
    for t in range(min(WARMUP, len(scans))):
        t0 = time.perf_counter()
        runner.process_scan(scans[t], stamps[t], sync=True)
        secs.append(time.perf_counter() - t0)
    start = WARMUP
    if chunk > 1 and len(scans) - WARMUP > chunk:
        t0 = time.perf_counter()
        runner.process_chunk(scans[WARMUP: WARMUP + chunk],
                             stamps[WARMUP: WARMUP + chunk]).position.cpu()
        secs.append(time.perf_counter() - t0)
        start = WARMUP + chunk
    return start, secs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 93 frames = 5 warm-up frames, one chunk, 10 measured chunks of 8: no
    # tail of single frames. The ATE gate scales with the path length and
    # the world's extent with the frame count.
    ap.add_argument("--frames", type=int, default=93)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); without it the "
                         "bench needs a card")
    ap.add_argument("--batch", type=int, default=None,
                    help="measure aggregate multi-sequence throughput")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per process_chunk call in the steady loop "
                         "(1 = per-frame process_scan)")
    ap.add_argument("--inflight", type=int, default=3,
                    help="chunks kept in flight before reading the oldest (--stream)")
    ap.add_argument("--stream", action="store_true",
                    help="prepare each chunk just in time in a worker thread (the online "
                         "protocol) instead of staging every chunk on the device before "
                         "the measured loop (the offline default)")
    ap.add_argument("--loop", action="store_true",
                    help="run only the loop-closure repair check (closed-loop world, "
                         "noise-burst drift, posegraph.use=true) and print its JSON line")
    ap.add_argument("--loop-frames", type=int, default=144)
    ap.add_argument("--loop-ring", type=int, default=None,
                    help="keyframe ring capacity for --loop")
    ap.add_argument("--no-loop", action="store_true",
                    help="skip the loop-closure check appended to the default run's line")
    ap.add_argument("--imu", action="store_true",
                    help="feed the synthesized 100 Hz gyro (from ground truth, with noise, "
                         "no bias) through runner.push_imu into every runner")
    ap.add_argument("--dyn", type=int, default=-1,
                    help="number of moving boxes in the world (-1 = the world's default)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="dotted config override, e.g. gicp.s2s.optimizer=gn (the CLI's "
                         "syntax)")
    return ap.parse_args(argv)


def main(argv=None, trajectories: dict | None = None) -> dict:
    """Run the bench with ``argv`` (``sys.argv[1:]`` when None), print its
    JSON line and return it. ``trajectories``, when given, receives the
    trajectory ([N, 4, 4]) of each full pass of the single-sequence bench
    by name: "pass 1" (the scored one), "pass 2" and "pass 3" (offline
    mode) and "stream"."""
    args = parse_args(argv)
    if args.batch:
        out = run_batched(args)
    elif args.loop:
        res = loop_closure_check(with_overrides(production_cfg(args.small), args.set),
                                 frames=args.loop_frames, ring=args.loop_ring,
                                 per_frame_detail=True, device=_device(args))
        out = {"metric": "loopclosure_map_repair", "value": res["kf_map_err_after_m"],
               "unit": "m", **res}
    else:
        out = run_single(args, trajectories)
    print(json.dumps(out))
    return out


def run_single(args, trajectories: dict | None = None) -> dict:
    """The single-sequence bench (the module docstring's protocol): its
    line."""
    dev = _device(args)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {dev.type} {name}", file=sys.stderr)

    cfg = with_overrides(production_cfg(args.small), args.set)
    if args.imu:
        # calib_time 0: the synthesized gyro has no bias and the platform
        # moves from frame 0; the buffer holds the whole run (every sample
        # is pushed up front)
        cfg = cfg.replace(imu=dataclasses.replace(
            cfg.imu, use=True, calib_time=0.0, buffer_size=max(2000, args.frames * 16)))

    t_setup = time.perf_counter()
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(
        args.frames, rng, args.small, n_dynamic=None if args.dyn < 0 else args.dyn)
    scans = [synthetic.render_scan(world, t, rng, max_range=max_range, max_points=max_pts,
                                   beams=beams) for t in range(args.frames)]
    stamps = [float(s) for s in world.stamps[: len(scans)]]
    print(f"# {len(scans)} scans, mean {np.mean([len(s) for s in scans]):.0f} raw pts, "
          f"rendered in {time.perf_counter() - t_setup:.1f} s", file=sys.stderr)

    def new_runner() -> OdometryRunner:
        runner = OdometryRunner(cfg, device=dev)
        if args.imu:
            n_imu = push_imu(runner, world, len(scans))
            print(f"# pushed {n_imu} synthesized IMU samples (100 Hz gyro)", file=sys.stderr)
        return runner

    chunk = max(1, args.chunk)
    t_cold = time.perf_counter()
    runner = new_runner()
    start, secs = prime(runner, scans, stamps, chunk)
    for t, s in enumerate(secs[:WARMUP]):
        print(f"# frame {t}: {s * 1e3:.1f} ms (warm-up; the first builds the kernels)",
              file=sys.stderr)
    if len(secs) > WARMUP:
        print(f"# first chunk ({chunk} frames): {secs[-1]:.2f} s", file=sys.stderr)
    print(f"# cold start to steady state: {time.perf_counter() - t_cold:.1f} s "
          f"(runner, kernel build at first use, warm-up)", file=sys.stderr)

    with ThreadPoolExecutor(1) as executor:
        head = measured_loop(runner, scans, stamps, start, chunk, args.stream, args.inflight,
                             executor)
        ms_wall = head["wall_ms"]
        n_steady = head["n"]
        offline_passes = [ms_wall]
        if args.stream and "median_ms" in head:
            ms, estimator = head["median_ms"], "median_chunk"
        else:
            ms, estimator = ms_wall, "wall_avg"
        protocol = "stream" if args.stream else "prestaged"
        fps = 1000.0 / ms

        # score the trajectory before any re-stepping of the runner: a fast but
        # divergent pipeline reports no speed
        est = runner.trajectory()[: len(world.poses)]
        if trajectories is not None:
            trajectories["pass 1"] = est
        gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
        ate = evaluation.ate(est, gt, align=False)
        path_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
        gate = max(0.10, 0.001 * path_len)
        if not np.isfinite(ate.rmse) or ate.rmse > gate:
            return {
                "metric": "odometry_frames_per_s_per_chip",
                "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
                "error": f"diverged: ATE {ate.rmse:.3f} m (gate {gate:.2f})",
            }

        def fresh_pass() -> OdometryRunner:
            rp = new_runner()
            prime(rp, scans, stamps, chunk)
            return rp

        # offline headline: the median of 3 passes, each a fresh runner
        # re-processing every frame (the trajectory was scored from pass 1)
        if not args.stream and chunk > 1 and not args.small:
            for i in range(2):
                rp = fresh_pass()
                offline_passes.append(measured_loop(rp, scans, stamps, start, chunk, False,
                                                    args.inflight, executor)["wall_ms"])
                if trajectories is not None:
                    trajectories[f"pass {i + 2}"] = rp.trajectory()
                del rp
            ms = float(np.median(offline_passes))
            ms_wall = ms
            fps = 1000.0 / ms
            estimator = "median_of_3_wall_avg"
            print("# offline passes (ms/frame): " + " ".join(f"{p:.2f}" for p in offline_passes),
                  file=sys.stderr)

        # the best of 3 synced chunks (input staged before each clock)
        # (GICP iterations are data-dependent host loops here: re-stepping
        # the last scans from the end pose changes them, so they are printed)
        iterations = {"measured": [gicp_iterations(st.result)
                                   for st in runner.stats[start: len(scans)]]}
        ms_synced = ms
        if chunk > 1 and len(scans) - start >= chunk:
            best = []
            pre = runner.prepare_chunk(scans[-chunk:])
            _sync(dev)
            for i in range(3):
                tb = time.perf_counter()
                r = runner.process_chunk(scans[-chunk:], [s + 0.1 for s in stamps[-chunk:]],
                                         prepared=pre)
                r.position.cpu()
                best.append(time.perf_counter() - tb)
                iterations[f"synced chunk {i + 1}"] = gicp_iterations(r)
            ms_synced = min(best) / chunk * 1e3

        t0 = time.perf_counter()
        r = runner.process_scan(scans[-1], stamps[-1] + 0.1, sync=True)
        lat_ms = (time.perf_counter() - t0) * 1e3
        iterations["latency frame"] = gicp_iterations(r)
        print(f"# GICP iterations a frame (S2S + S2M): {json.dumps(iterations)}",
              file=sys.stderr)
        print(f"# steady state: {ms:.2f} ms/frame {estimator} ({ms_synced:.2f} synced chunk, "
              f"{ms_wall:.2f} wall avg, {n_steady} frames), {lat_ms:.2f} ms synced latency, "
              f"{runner.num_keyframes()} keyframes, ATE {ate.rmse * 100:.2f} cm", file=sys.stderr)

        # the online (streamed) number in the same line: the measured frames
        # again through a fresh runner, chunks prepared just in time
        stream_fps = None
        if not args.stream and chunk > 1 and not args.small and len(scans) - start >= 6 * chunk:
            r2 = fresh_pass()
            sec = measured_loop(r2, scans, stamps, start, chunk, True, args.inflight, executor)
            if trajectories is not None:
                trajectories["stream"] = r2.trajectory()
            del r2
            stream_fps = 1000.0 / sec.get("median_ms", sec["wall_ms"])
            print(f"# online (stream) protocol: {1000.0 / stream_fps:.2f} ms/frame median chunk",
                  file=sys.stderr)

        out = {
            "metric": "odometry_frames_per_s_per_chip",
            "value": round(fps, 2),
            "unit": "frames/s",
            "vs_baseline": round(fps / DLO_CPU_FPS, 3),
            "vs_baseline_same_work": round(fps / DLO_CPU_FPS, 3),
            "vs_cpu_same_host_2core": round(fps / DLO_CPU_FPS_2CORE, 3),
            "protocol": protocol,
            "estimator": estimator,
            "offline_passes_ms_per_frame": [round(p, 2) for p in offline_passes],
            "wall_avg_fps": round(1000.0 / ms_wall, 2),
            "synced_chunk_fps": round(1000.0 / ms_synced, 2),
            "ate_rmse_m": round(float(ate.rmse), 4),
            "ate_pct_per_m": round(float(ate.rmse) / max(path_len, 1e-9) * 100, 4),
            "gate_m": round(gate, 3),
            "cpu_baseline_fps_2core_measured": DLO_CPU_FPS_2CORE,
            "cpu_baseline_ate_m": DLO_CPU_ATE_M,
        }
        if stream_fps is not None:
            out["stream_fps"] = round(stream_fps, 2)
            out["vs_baseline_stream"] = round(stream_fps / DLO_CPU_FPS, 3)
        if not args.no_loop and not args.small and not args.cpu:
            out["loopclosure"] = loop_closure_check(with_overrides(production_cfg(False), args.set),
                                                    device=dev)
        return out


if __name__ == "__main__":
    sys.exit(1 if "error" in main() else 0)
