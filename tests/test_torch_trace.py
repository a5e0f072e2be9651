"""The port's tracing (``utils/sync.py``) on the CPU: self time against
nested spans and threads, ``reset``, the read waits against the host-read
count, the GICP iteration counters against every align's own count, the
spans kept apart and stamped on the profiler's clock while a profiler
runs, and a traced frame's operations and poses unchanged by the spans.

One torch thread; a few frames at tiny shapes.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu_torch.io import synthetic
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.registration import gicp
from direct_lidar_odometry_tpu_torch.utils import sync

CFG = DloConfig(shapes=ShapeConfig(n_raw=8192, n_scan=2048, n_keyframe=1024, max_keyframes=16,
                                   max_submap_kf=4, n_submap_flat=4096, hull_directions=16))
N_FRAMES = 5  # the first through process_scan, then one chunk of 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    sync.reset()
    yield
    torch.set_num_threads(n)
    sync.reset()


@pytest.fixture(scope="module")
def drive():
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=N_FRAMES, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=16, n_azimuth=512)
    scans = [synthetic.render_raycast(world, t, rng, max_points=8192, beams=beams)
             for t in range(N_FRAMES)]
    return scans, [float(s) for s in world.stamps[:N_FRAMES]]


def _runner(drive):
    """A runner past its first frame, and the chunk still to run."""
    scans, stamps = drive
    runner = OdometryRunner(CFG, "cpu")
    runner.process_scan(scans[0], stamps[0])
    return runner, scans[1:], stamps[1:]


def test_self_time_is_duration_less_children():
    with sync.span("outer"):
        with sync.span("inner"):
            time.sleep(0.002)
        with sync.span("inner"):
            sync.read(torch.ones(2))
            time.sleep(0.001)
        time.sleep(0.001)
    t = sync.totals()
    n_in, total_in, self_in = t.spans["inner"]
    n_out, total_out, self_out = t.spans["outer"]
    (n_w, wait_ns), = [v for k, v in t.waits.items() if k[:2] == ("read", "inner")]
    assert (n_in, n_out, n_w) == (2, 1, 1)
    assert self_out == total_out - total_in
    assert self_in == total_in - wait_ns
    assert self_out >= 1_000_000 and total_out >= total_in + 1_000_000


def test_spans_of_two_threads_do_not_nest():
    started, release = threading.Event(), threading.Event()

    def worker():
        with sync.span("b"):
            started.set()
            release.wait(5)
            sync.read(torch.ones(1))

    th = threading.Thread(target=worker)
    with sync.span("a"):
        th.start()
        assert started.wait(5)
        time.sleep(0.003)
        release.set()
        th.join(5)
    assert not th.is_alive()
    t = sync.totals()
    assert t.spans["a"][1] == t.spans["a"][2]  # the worker's span is no child of a
    (wait_key,) = t.waits
    assert wait_key == ("read", "b", False)
    assert t.spans["b"][2] == t.spans["b"][1] - t.waits[wait_key][1]


def test_counts_and_spans_survive_concurrent_threads():
    n_threads, n = 8, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with sync.span("hot"):
                    sync.count("hits")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sync.counts["hits"] == n_threads * n
    assert sync.totals().spans["hot"][0] == n_threads * n


def test_reset_clears_everything():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with sync.span("x"):
            sync.read(torch.ones(1))
            sync.count("c", 3)
    with sync.span("y"):
        sync.count("c")
    assert sync.timeline() and sync.totals().spans and sync.totals(profiled=True).spans
    sync.reset()
    assert sync.counts["host_reads"] == 0 and sync.counts["c"] == 0
    for profiled in (False, True):
        t = sync.totals(profiled)
        assert t.spans == {} and t.waits == {} and t.counts == {}
    assert sync.timeline() == []


def test_drive_counts_reads_frames_and_every_align(drive, monkeypatch):
    align = gicp.align
    called = {"calls": 0, "iters": 0}

    def counted(*args, **kwargs):
        res = align(*args, **kwargs)
        called["calls"] += 1
        called["iters"] += res.iterations
        return res

    monkeypatch.setattr(gicp, "align", counted)
    runner, scans, stamps = _runner(drive)
    runner.process_chunk(scans, stamps)
    t = sync.totals()
    reads = sum(n for (kind, *_), (n, _) in t.waits.items() if kind == "read")
    assert reads == sync.counts["host_reads"] > 0
    iters = {k: v for k, v in t.counts.items() if k.startswith("align_iters.")}
    assert sum(iters.values()) == called["iters"]
    assert t.counts["align_iters.step.s2s_coarse"] > 0  # the coarse align is counted
    assert sum(v for k, v in t.counts.items() if k.startswith("lm_steps.")) >= called["iters"]
    assert t.counts["frames"] == N_FRAMES - 1 and t.counts["frames_prepared"] == N_FRAMES - 1
    assert t.spans["step"][0] == N_FRAMES - 1 and t.spans["runner.chunk"][0] == 1
    # the runner's frame times are its spans'
    scan_ns, chunk_ns = t.spans["runner.scan"][1], t.spans["runner.chunk"][1]
    assert runner.stats[0].wall_ms == scan_ns / 1e6
    assert runner.stats[-1].wall_ms == chunk_ns / 1e6 / (N_FRAMES - 1)
    # every step stage is a child of step: step's self time is what they leave
    stages = [k for k in t.spans if k.startswith("step.")]
    assert {"step.preprocess", "step.normals", "step.s2s", "step.submap", "step.s2m",
            "step.keyframe"} <= set(stages)
    step_waits = sum(ns for (_, site, _), (_, ns) in t.waits.items() if site == "step")
    assert t.spans["step"][2] == (t.spans["step"][1] - sum(t.spans[k][1] for k in stages)
                                  - step_waits)


def _kineto(prof):
    return list(prof.profiler.kineto_results.events())


def test_profiled_spans_are_apart_and_on_the_profilers_clock(drive):
    runner, scans, stamps = _runner(drive)
    sync.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("chunk"):
            runner.process_chunk(scans[:2], stamps[:2])
    with sync.span("after"):
        pass
    assert set(sync.totals().spans) == {"after"}
    apart = sync.totals(profiled=True)
    assert apart.spans["step"][0] == 2 and apart.counts["frames"] == 2
    events = _kineto(prof)
    (rf,) = [e for e in events if e.name() == "chunk"]
    names = {e.name() for e in events}
    # no program span is a profiler annotation
    assert not any(n.startswith(("runner.", "step", "wait.")) for n in names)
    line = sync.timeline()
    assert {e.name for e in line} >= {"runner.chunk", "step", "step.s2m", "wait.read"}
    assert all(e.name != "after" for e in line)
    tol = 100_000  # ns
    for e in line:
        assert rf.start_ns() - tol <= e.start_ns <= e.end_ns <= rf.end_ns() + tol, e
    chunk = [e for e in line if e.name == "runner.chunk"]
    steps = [e for e in line if e.name == "step"]
    assert len(chunk) == 1 and [e.parent for e in steps] == ["runner.chunk"] * 2
    assert [e.frame for e in steps] == [0, 1]


class _NoSpan:
    """A span that records nothing."""

    ns = 0
    ms = 0.0

    def __init__(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _traced_chunk(drive):
    runner, scans, stamps = _runner(drive)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        res = runner.process_chunk(scans[:2], stamps[:2])
    ops = [e.name() for e in sorted(_kineto(prof), key=lambda e: e.start_ns())
           if e.name().startswith("aten::")]
    return ops, res.pose


def test_spans_change_no_operation_and_no_pose(drive, monkeypatch):
    ops, pose = _traced_chunk(drive)
    monkeypatch.setattr(sync, "Span", _NoSpan)
    ops_off, pose_off = _traced_chunk(drive)
    assert len(ops) > 1000
    assert ops == ops_off
    assert torch.equal(pose, pose_off)
