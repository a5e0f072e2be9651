"""The offline traffic on a route that revisits, with loop closure on.

As ``offline.py`` (whose functions it uses): a logged drive re-processed
as fast as the port goes on a fresh ``OdometryRunner``, the first frame
through ``process_scan`` and the rest through ``process_chunk`` in chunks
prepared just in time by a worker thread, each chunk's gyro pushed ahead
of it. The route is the cloverleaf of ``traffic/cloverleaf.py``; the drive
is as long as the window reaches at ``cover_rate_hz``, at most the route,
and a fresh runner repeats it past its end. Loop-closure rounds fire from
the runner's own trigger (``posegraph.check_every`` frames, counted by
chunk); none is forced in the window.

Set-up warms every path a round takes: a runner with the candidate gates
opened (no spawn-frame or rank gap, any distance) drives ``warm_chunks``
chunks, so its trigger runs rounds that register loop edges (capturing
the loop stage's GICP graphs) and solve the ring's dense system (the
solver's first call), then the window opens on a fresh runner. A program
whose ``process_chunk`` runs no round stops there with an error.

For the check the harness records, on the first pass, each chunk's state
before any round that follows it, and each round: the ring before it, its
candidate pairs, each loop edge's ``Z_ij``, weight and target cloud, and
the ring after it (device copies taken by wrapping the port's
``refine_and_reanchor`` and ``register_loop_edges``; no host read). The
judged frames are chunks and rounds drawn from the run's seed
(``reference/loop.py``). The window is the offline window:
``frames_per_s`` reads it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import devprof, harness
from benchmark.drivers import offline
from benchmark.reference import loop as ref_loop
from benchmark.traffic import cloverleaf
from benchmark.traffic import world as bw


class RoundRecorder:
    """Wraps the port's round while :attr:`on`: the chunk's state before
    the round, the round's inputs and outputs (device copies)."""

    def __init__(self, loopclosure):
        self.lc = loopclosure
        self.real_round = loopclosure.refine_and_reanchor
        self.real_register = loopclosure.register_loop_edges
        self.on = False
        self.frame = 0        # the last frame the driver stepped
        self.rounds: list[tuple[harness.Capture, ref_loop.Round, int]] = []
        self._pending: dict | None = None

    def __enter__(self):
        self.lc.refine_and_reanchor = self._round
        self.lc.register_loop_edges = self._register
        return self

    def __exit__(self, *exc):
        self.lc.refine_and_reanchor = self.real_round
        self.lc.register_loop_edges = self.real_register
        return False

    def _register(self, store, edges, mask, cfg, backend):
        loops = self.real_register(store, edges, mask, cfg, backend)
        if self._pending is not None:
            i = loops.edges[:, 0]
            self._pending.update(edges=loops.edges.clone(), mask=loops.mask.clone(),
                                 rel=loops.rel.clone(), weight=loops.weight.clone(),
                                 cloud_i=store.points[i], cloud_i_mask=store.masks[i])
        return loops

    def _round(self, state, cfg, backend):
        if not self.on:
            return self.real_round(state, cfg, backend)
        kf = state.keyframes
        before = harness.capture_state(state, self.frame)
        self._pending = dict(frame=self.frame, count=kf.count.clone(), positions=before.kf_positions,
                             quats=before.kf_quats, seq=before.kf_seq, health=kf.health.clone())
        try:
            state, info = self.real_round(state, cfg, backend)
        finally:
            rec, self._pending = self._pending, None
        kf = state.keyframes
        rnd = ref_loop.Round(post_positions=kf.positions.clone(), post_quats=kf.quats.clone(), **rec)
        self.rounds.append((before, rnd, info.n_candidates))
        return state, info


class RefineWindow(devprof.Window):
    """The profiled sub-window. :meth:`stop` only closes the profiler, so
    that reading its trace (seconds of host work on this cell's many
    device operations) falls after the measured window: :meth:`summary`
    gives ``devprof.window_summary``'s reading, and the device's busy time
    inside the program's ``runner.refine`` spans (``utils/sync.py``'s
    timeline, on the profiler's clock)."""

    def stop(self) -> None:
        self.window_s = time.perf_counter() - self.t0
        self.rec.profiling = False
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        out = devprof.window_summary(self.prof, self.window_s)
        if out is not None:
            from direct_lidar_odometry_tpu_torch.utils import sync

            busy = devprof.merged([(a, b) for _, a, b in
                                   devprof.device_events(devprof.kineto_events(self.prof))])
            spans = [(e.start_ns, e.end_ns) for e in getattr(sync, "timeline", list)()
                     if e.name == "runner.refine"]
            out["refine_rounds"] = len(spans)
            out["refine_device_s"] = sum(max(0, min(b, d) - max(a, c))
                                         for a, b in spans for c, d in busy) / 1e9
        return out


def run(ctx) -> harness.RunLog:
    from direct_lidar_odometry_tpu_torch.odometry import loopclosure
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.parallel import posegraph
    from direct_lidar_odometry_tpu_torch.utils import sync

    tr = ctx.cell.traffic
    route = tr["route"]
    k = tr["chunk"]
    n_chunks = min(int(math.ceil(ctx.seconds * tr["cover_rate_hz"] / k)),
                   route["petals"] * route["petal_frames"] // k)
    n_frames = 1 + n_chunks * k
    log = harness.RunLog("offline")
    rec = log.rec
    with rec.span("render"):
        world = cloverleaf.build_cloverleaf(ctx.cell.config["world"], route,
                                            np.random.SeedSequence(offline.drive_worlds(ctx)[0]))
        scans = offline.render_drive(ctx, world, 0, n_frames)
        imu = offline.drive_imu(ctx, world, 0, n_frames)
    stream = torch.cuda.current_stream(ctx.device) if ctx.device.type == "cuda" else None
    executor = ThreadPoolExecutor(max_workers=1)
    recorder = RoundRecorder(loopclosure)
    captures: list[harness.Capture] = []
    windows: list[RefineWindow] = []
    pg = ctx.cfg.posegraph
    open_gates = ctx.cfg.replace(posegraph=dataclasses.replace(
        pg, min_seq_gap=0, min_index_gap=1, loop_radius=1e9, refine_every_kf=1, check_every=k))

    def prepare(runner, c):
        with torch.cuda.stream(stream), rec.span("prepare", k):
            return runner.prepare_chunk(scans[1 + c * k: 1 + (c + 1) * k])

    def drive_pass(p: int, window_end: float | None, warm: bool = False):
        with rec.span("runner_init"):
            runner = OdometryRunner(open_gates if warm else ctx.cfg, ctx.device)
            offline.push_imu(runner, imu[0])
            runner.process_scan(scans[0], 0.0)
        done = 1
        last = tr["warm_chunks"] if warm else n_chunks
        nxt = executor.submit(prepare, runner, 0)
        first = p == 0 and not warm
        recorder.on = first
        win = RefineWindow(ctx.device, rec) if ctx.trace and first else None
        if win is not None:
            windows.append(win)
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
                offline.push_imu(runner, imu[f])
            recorder.frame = frames.stop - 1
            n_rounds = len(recorder.rounds)
            with rec.span("step", k):
                res = runner.process_chunk(scans[frames.start:frames.stop],
                                           [0.1 * f for f in frames], prepared=prepared)
            if first:  # the chunk's state before a round that followed it
                ran = len(recorder.rounds) > n_rounds
                captures.append(recorder.rounds[-1][0] if ran else
                                harness.capture_state(runner.state, frames.stop - 1))
            with rec.span("pose_read", k):
                pose = res.pose.cpu()
            done += k
            log.lost += int((~torch.isfinite(pose).all(dim=(1, 2))).sum())
            log.gicp_iters += sum(res.s2s_iterations) + sum(res.s2m_iterations)
            if win is not None and c == p1 - 1:
                win.stop()
                log.profile_units = (p1 - p0) * k
        if win is not None and rec.profiling:  # the window closed inside the sub-window
            win.stop()
        recorder.on = False
        return runner, done

    try:
        with recorder:
            with rec.span("warm"):  # set-up: kernels, worker, the loop stage's graphs, the solver
                runner, _ = drive_pass(0, None, warm=True)
                if not runner.refine_log:
                    raise RuntimeError("loop traffic: the program's process_chunk ran no "
                                       "loop-closure round; this traffic needs its trigger")
                if not any(e["n_accepted"] for e in runner.refine_log):
                    kf = runner.state.keyframes
                    posegraph.refine(posegraph.odometry_chain_graph(
                        kf.positions, kf.quats, kf.count, seq=kf.seq), iterations=pg.iterations)
                del runner
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
    if windows and log.profile_units:
        log.profile = windows[0].summary()
    drive = offline.judge_drive(ctx, scans, emitted)
    # the judged chunks and rounds: drawn from the seed among the first
    # pass's chunks, and among its rounds with candidates whose next chunk
    # was stepped
    pick = harness.seeded_choice(bw.seed_words(ctx.seed, 3, 0), len(captures), tr["judged_chunks"])
    log.judged = [(drive, captures[i]) for i in pick]
    chunk_of = {cap.frame: c for c, cap in enumerate(captures)}
    rounds = [(rnd, chunk_of[rnd.frame] + 1) for _, rnd, n in recorder.rounds
              if n > 0 and chunk_of.get(rnd.frame, len(captures)) + 1 < len(captures)]
    if not rounds:
        raise RuntimeError("loop traffic: no loop-closure round with candidates to judge in "
                           "the first pass")
    pg_dict = ctx.cell.dlo["posegraph"]
    for r in harness.seeded_choice(bw.seed_words(ctx.seed, 3, 1), len(rounds), tr["judged_rounds"]):
        rnd, nxt_chunk = rounds[r]
        log.judged += ref_loop.judged_frames(drive, rnd, captures[nxt_chunk], pg_dict)
    return log
