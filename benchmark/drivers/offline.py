"""The offline traffic: a logged drive re-processed as fast as the port goes.

The drive runs on a fresh ``OdometryRunner``: its first frame through
``process_scan``, the rest through ``process_chunk`` in chunks, each chunk
prepared just in time (``prepare_chunk``: host preprocessing, the wire
encoding, the copy to the device) by one worker thread on the caller's
CUDA stream while the previous chunk runs, and its poses read to the
host. The drive's IMU samples are pushed into the runner ahead of each
chunk. The drive is as long as the window reaches at ``cover_rate_hz``;
a faster port replays it on a fresh runner. The window counts the frames
whose poses reached the host over all the time they took.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import devprof, harness
from benchmark.reference.judge import Drive
from benchmark.traffic import world as bw


def drive_worlds(ctx) -> list[int]:
    """The traffic's fixed worlds (``world_seeds``), in an order drawn from
    the run's seed: every seed drives the same logs."""
    seeds = list(ctx.cell.traffic["world_seeds"])
    order = np.random.default_rng(bw.seed_words(ctx.seed, 1)).permutation(len(seeds))
    return [seeds[i] for i in order]


def make_world(ctx, world_seed: int, n_frames: int, closed_loop: bool = False) -> bw.BoxWorld:
    return bw.build_world(ctx.cell.config["world"], n_frames, closed_loop,
                          np.random.SeedSequence(world_seed))


def log_words(ctx, kind: int, stream: int) -> np.random.SeedSequence:
    """A seed sequence of the logged drive ``stream``: from the traffic's
    fixed ``log_seed``, not the run's, since a log is the same data on every
    run (the run's seed draws which of its frames are judged)."""
    return bw.seed_words(ctx.cell.traffic["log_seed"], kind, stream)


def render_drive(ctx, world: bw.BoxWorld, stream: int, n_frames: int) -> list[np.ndarray]:
    """A drive's raw scans as host arrays of returns ([M, 3] float32):
    frame t at pose t mod the world's length (laps of a closed route,
    every frame rendered anew), its sweep's beam jitter and range noise
    from the log's seed (``stream`` tells the drives apart), rendered on
    the device and copied to the host at once."""
    sensor = bw.Sensor(**ctx.cell.config["sensor"])
    dw = bw.DeviceWorld(world, ctx.device)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(log_words(ctx, 2, stream).generate_state(1, np.uint64)[0]))
    pts = torch.empty((n_frames, sensor.n_rays, 3), device=ctx.device)
    ok = torch.empty((n_frames, sensor.n_rays), dtype=torch.bool, device=ctx.device)
    for t in range(n_frames):
        pts[t], ok[t] = bw.render(dw, t % len(world.poses), sensor, gen, stamp=0.1 * t)
    pts_h, ok_h = pts.cpu().numpy(), ok.cpu().numpy()
    return [pts_h[t][ok_h[t]] for t in range(n_frames)]


def drive_imu(ctx, world: bw.BoxWorld, stream: int, n_frames: int) -> list[np.ndarray]:
    """The drive's IMU rows by frame (``world.imu_rows``): the traffic's
    rate and gyro noise, a rest of the configuration's calibration time."""
    tr = ctx.cell.traffic
    rot = world.poses[np.arange(n_frames) % len(world.poses), :3, :3]
    return bw.imu_rows(rot, 0.1 * np.arange(n_frames), tr["imu_rate_hz"], tr["gyro_noise_rad_s"],
                       ctx.cfg.imu.calib_time, log_words(ctx, 4, stream))


def push_imu(runner, rows: np.ndarray) -> None:
    """A frame's IMU samples into the runner (a no-op without ``imu.use``)."""
    for r in rows:
        runner.push_imu(float(r[0]), r[1:4], r[4:7])


def judge_drive(ctx, scans, poses) -> Drive:
    return Drive(ctx.cell.config["dlo"], lambda f: torch.from_numpy(scans[f]),
                 lambda f: poses[f], ctx.cell.dlo["quantize_transfer"], ctx.device)


def run(ctx) -> harness.RunLog:
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import sync

    tr = ctx.cell.traffic
    k = tr["chunk"]
    n_chunks = int(math.ceil(ctx.seconds * tr["cover_rate_hz"] / k))
    n_frames = 1 + n_chunks * k
    log = harness.RunLog("offline")
    rec = log.rec
    with rec.span("render"):
        world = make_world(ctx, drive_worlds(ctx)[0], n_frames)
        scans = render_drive(ctx, world, 0, n_frames)
        imu = drive_imu(ctx, world, 0, n_frames)
    stream = torch.cuda.current_stream(ctx.device) if ctx.device.type == "cuda" else None
    executor = ThreadPoolExecutor(max_workers=1)

    def prepare(runner, c):
        with torch.cuda.stream(stream), rec.span("prepare", k):
            return runner.prepare_chunk(scans[1 + c * k: 1 + (c + 1) * k])

    def drive_pass(p: int, window_end: float | None, warm: bool = False):
        with rec.span("runner_init"):
            runner = OdometryRunner(ctx.cfg, ctx.device)
            push_imu(runner, imu[0])
            runner.process_scan(scans[0], 0.0)
        done = 1
        last = n_chunks if not warm else 2
        nxt = executor.submit(prepare, runner, 0)
        first = p == 0 and not warm
        win = devprof.Window(ctx.device, rec) if ctx.trace and first else None
        p0, p1 = tr["profile_from_chunk"], tr["profile_from_chunk"] + tr["profile_chunks"]
        for c in range(last):
            if window_end is not None and time.perf_counter() >= window_end:
                nxt.result()
                break
            if win is not None and c == p0:
                win.start()
            prepared = nxt.result()
            if c + 1 < last:
                nxt = executor.submit(prepare, runner, c + 1)
            frames = range(1 + c * k, 1 + (c + 1) * k)
            for f in frames:
                push_imu(runner, imu[f])
            with rec.span("step", k):
                res = runner.process_chunk(scans[frames.start:frames.stop],
                                           [0.1 * f for f in frames], prepared=prepared)
            if first:
                log.judged.append(harness.capture_state(runner.state, frames.stop - 1))
            with rec.span("pose_read", k):
                pose = res.pose.cpu()
            done += k
            log.lost += int((~torch.isfinite(pose).all(dim=(1, 2))).sum())
            log.gicp_iters += sum(res.s2s_iterations) + sum(res.s2m_iterations)
            if win is not None and c == p1 - 1:
                log.profile, log.profile_units = win.stop(), (p1 - p0) * k
        return runner, done

    try:
        with rec.span("warm"):  # set-up: the kernels, the native library, the worker
            drive_pass(0, None, warm=True)
            harness.synchronize(ctx.device)
        sync.reset()
        t0 = ctx.open_window()
        end = t0 + ctx.seconds
        p = 0
        emitted = None
        while time.perf_counter() < end:
            runner, done = drive_pass(p, end)
            log.frames += done
            if p == 0:
                emitted = harness.pose_rows(runner.poses)
            del runner
            p += 1
        log.window_s = time.perf_counter() - t0
        log.attempted = log.frames
        log.host_reads = sync.counts["host_reads"]
    finally:
        executor.shutdown(wait=True)
    # the judged frames: drawn from the seed among the first pass's chunks
    # that the window reached (every one was captured)
    pick = harness.seeded_choice(bw.seed_words(ctx.seed, 3, 0), len(log.judged),
                                 tr["judged_chunks"])
    drive = judge_drive(ctx, scans, emitted)
    log.judged = [(drive, log.judged[i]) for i in pick]
    return log
