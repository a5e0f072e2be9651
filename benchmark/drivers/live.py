"""The live traffic: one car running odometry at the sensor's rate.

Open loop: scan i is due ``i / rate_hz`` seconds after the window opens.
The feed sleeps until then, as a sensor callback waits for its sweep, and
sends it to ``process_scan(sync=True)``, or at once when the previous frame
ran late, so a slow frame (a keyframe spawn) delays the frames behind it.
The IMU samples up to a sweep are pushed before it is due. A frame's
latency runs from when it was due to when its pose is on the host. The
route is a closed lap driven again and again, every frame rendered anew.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import devprof, harness
from benchmark.drivers.offline import (drive_imu, drive_worlds, judge_drive, make_world, push_imu,
                                       render_drive)
from benchmark.traffic import world as bw


def run(ctx) -> harness.RunLog:
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import sync

    tr = ctx.cell.traffic
    rate = tr["rate_hz"]
    w = tr["warmup_frames"]
    n = int(math.ceil(ctx.seconds * rate))
    log = harness.RunLog("live")
    rec = log.rec
    with rec.span("render"):
        world = make_world(ctx, drive_worlds(ctx)[0], tr["lap_frames"], closed_loop=True)
        scans = render_drive(ctx, world, 0, w + n)
        imu = drive_imu(ctx, world, 0, w + n)
    runner = OdometryRunner(ctx.cfg, ctx.device)
    with rec.span("warm"):  # set-up: the first frames build the kernels and the map
        for i in range(w):
            push_imu(runner, imu[i])
            runner.process_scan(scans[i], 0.1 * i, sync=True)
    # the last frames are profiled: tracing slows them, and an open loop
    # carries that into every later frame
    p0 = w + n - min(n, tr["profile_frames"])
    win = devprof.Window(ctx.device, rec) if ctx.trace else None
    sync.reset()
    t0 = ctx.open_window()
    for i in range(w, w + n):
        due = t0 + (i - w) / rate
        if win is not None and i == p0:
            win.start()
        push_imu(runner, imu[i])
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        start = time.perf_counter()
        if not rec.profiling:
            log.queue_ms.append(max(0.0, start - due) * 1e3)
        with rec.span("step"):
            res = runner.process_scan(scans[i], 0.1 * i, sync=True)
        with rec.span("pose_read"):
            pose = res.pose.cpu() if res is not None else None
        if not rec.profiling:
            log.latencies_ms.append((time.perf_counter() - due) * 1e3)
        if pose is None or not bool(torch.isfinite(pose).all()):
            log.lost += 1
        else:
            log.gicp_iters += res.s2s_iterations + res.s2m_iterations
        log.judged.append(harness.capture_state(runner.state, i))
    log.window_s = time.perf_counter() - t0
    if win is not None:
        log.profile, log.profile_units = win.stop(), w + n - p0
    log.frames = log.attempted = n
    log.host_reads = sync.counts["host_reads"]
    drive = judge_drive(ctx, scans, harness.pose_rows(runner.poses))
    pick = harness.seeded_choice(bw.seed_words(ctx.seed, 3, 0), len(log.judged),
                                 tr["judged_frames"])
    log.judged = [(drive, log.judged[i]) for i in pick]
    return log
