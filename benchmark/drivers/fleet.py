"""The fleet traffic: several logged drives re-processed side by side.

One sequence a world of ``world_seeds`` goes through
``parallel.batched.make_batched_fns`` in lock-step. Every lane's raw scans sit on the device, padded to n_raw (the
port's batched path voxelises on the device; the per-step copy of the raw
scans from the host is left out). Each lane's IMU prior of every frame is
integrated from its gyro on the host by the port's ``odometry/imu.py``
before the window and kept on the device beside the scans. Two steps stay
in flight: after each step the previous step's poses are read to the host.
When the drives end, the lanes start again on a fresh batched state, the
same work again.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import devprof, harness
from benchmark.drivers.offline import drive_imu, drive_worlds, log_words, make_world
from benchmark.reference.judge import Drive
from benchmark.traffic import world as bw


def run(ctx) -> harness.RunLog:
    from direct_lidar_odometry_tpu_torch.odometry import imu as imu_mod
    from direct_lidar_odometry_tpu_torch.parallel import batched
    from direct_lidar_odometry_tpu_torch.utils import sync

    tr = ctx.cell.traffic
    cfg = ctx.cfg
    worlds = drive_worlds(ctx)
    lanes, n_frames = len(worlds), tr["drive_frames"]
    conf = ctx.cell.config
    sensor = bw.Sensor(**conf["sensor"])
    log = harness.RunLog("fleet")
    rec = log.rec
    pts = torch.zeros((lanes, n_frames, cfg.shapes.n_raw, 3), device=ctx.device)
    mask = torch.zeros((lanes, n_frames, cfg.shapes.n_raw), dtype=torch.bool, device=ctx.device)
    priors = np.tile(np.eye(4, dtype=np.float32), (n_frames, lanes, 1, 1))
    with rec.span("render"):
        for lane in range(lanes):
            world = make_world(ctx, worlds[lane], n_frames)
            dw = bw.DeviceWorld(world, ctx.device)
            gen = torch.Generator(device=ctx.device)
            gen.manual_seed(int(log_words(ctx, 2, worlds[lane]).generate_state(1, np.uint64)[0]))
            for t in range(n_frames):
                p, ok = bw.render(dw, t, sensor, gen)
                pts[lane, t, :len(p)] = p
                mask[lane, t, :len(p)] = ok
            if cfg.imu.use:
                buf = imu_mod.ImuBuffer(cfg.imu.calib_time, cfg.imu.buffer_size)
                for t, rows in enumerate(drive_imu(ctx, world, worlds[lane], n_frames)):
                    for r in rows:
                        buf.push(float(r[0]), r[1:4], r[4:7])
                    if t:
                        window, count = buf.window(0.1 * (t - 1), 0.1 * t, cfg.shapes.imu_window)
                        priors[t, lane] = imu_mod.integrate_window_host(window, count)
    priors = torch.from_numpy(priors).to(ctx.device)
    init_fn, step_fn = batched.make_batched_fns(cfg)
    iters = []  # device counts, read once the window has closed

    def one_pass(end: float | None, steps: int, first: bool):
        with rec.span("runner_init"):
            states = init_fn(batched.batched_state(cfg, lanes, device=ctx.device),
                             pts[:, 0], mask[:, 0])
        poses = [torch.eye(4, dtype=torch.float64).expand(lanes, 4, 4)]
        pending = None
        win = devprof.Window(ctx.device, rec) if ctx.trace and first else None
        p0, p1 = tr["profile_from_step"], tr["profile_from_step"] + tr["profile_steps"]
        for t in range(1, steps):
            if end is not None and time.perf_counter() >= end:
                break
            if win is not None and t == p0:
                win.start()
            with rec.span("step", lanes):
                states, res = step_fn(states, pts[:, t], mask[:, t], priors[t])
            if first and end is not None and t % tr["capture_every"] == 0:
                log.judged.append([harness.capture_state(states, t, lane)
                                   for lane in range(lanes)])
            if pending is not None:
                with rec.span("pose_read", lanes):
                    poses.append(pending.pose.to("cpu", torch.float64))
                log.steps += 1
            pending = res
            iters.append(res.s2s_iterations.sum() + res.s2m_iterations.sum())
            if win is not None and t == p1:
                # steps p0 .. p1 - 1 and the read of step p1 - 1's poses
                log.profile, log.profile_units = win.stop(), p1 - p0
        if pending is not None:
            with rec.span("pose_read", lanes):
                poses.append(pending.pose.to("cpu", torch.float64))
            log.steps += 1
        return torch.stack(poses, dim=1)  # [lanes, frames, 4, 4]

    with rec.span("warm"):
        one_pass(None, tr["warmup_steps"] + 1, first=False)
        harness.synchronize(ctx.device)
    log.steps = 0
    iters.clear()
    sync.reset()
    t0 = ctx.open_window()
    end = t0 + ctx.seconds
    emitted = None
    first = True
    while time.perf_counter() < end:
        poses = one_pass(end, n_frames, first)
        log.lost += int((~torch.isfinite(poses[:, 1:]).all(dim=(2, 3))).sum())
        if first:
            emitted = poses
        first = False
    log.window_s = time.perf_counter() - t0
    log.frames = log.attempted = log.steps * lanes
    log.gicp_iters = int(torch.stack(iters).sum()) if iters else 0
    log.host_reads = sync.counts["host_reads"]
    drives = {}
    for lane in range(lanes):
        drives[lane] = Drive(conf["dlo"], lambda f, lane=lane: pts[lane, f][mask[lane, f]],
                             lambda f, lane=lane: emitted[lane, f], False, ctx.device)
    # the judged steps: drawn from the seed among the captured steps whose
    # poses the window read; every lane of each
    steps = [caps for caps in log.judged if caps[0].frame < emitted.shape[1]]
    pick = harness.seeded_choice(bw.seed_words(ctx.seed, 3, 0), len(steps), tr["judged_steps"])
    log.judged = [(drives[lane], steps[i][lane]) for i in pick for lane in range(lanes)]
    return log
