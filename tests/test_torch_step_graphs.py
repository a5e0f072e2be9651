"""The per-frame step's stretches outside GICP replayed from graphs
(``utils/graphs.Stretches``, ``odometry/pipeline._stretches``), on the CPU.

A CUDA graph replays its captured kernels over the buffers it captured.
Here a stand-in capture keeps the stretch as a function over the graph's
buffers, and its replay runs that function again and writes the results
into the captured outputs: what a replay does, without the card. Through
it ``odom_frame`` (its inputs copied into each graph's buffers, one
stretch's outputs read where the graph before left them, the ring and the
submap cache written in place, what a frame hands on cloned) gives the
eager step's bits frame for frame over a ring that evicts, and each
stretch is captured once and replayed after. ``tests/test_torch_cuda.py``
holds the real graphs to the eager step on a card.

Small clouds from the port's own synthetic world; one torch thread.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, KeyframeConfig, ShapeConfig
from direct_lidar_odometry_tpu_torch.io import synthetic
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline
from direct_lidar_odometry_tpu_torch.odometry.state import state_to_numpy
from direct_lidar_odometry_tpu_torch.utils import graphs, sync

CFG = DloConfig(
    keyframe=KeyframeConfig(thresh_dist=0.5),
    shapes=ShapeConfig(n_raw=4096, n_scan=2048, n_keyframe=1024, max_keyframes=4,
                       max_submap_kf=2, n_submap_flat=2048, hull_directions=16,
                       grid_table_size=2 ** 12, cell_cap_1nn=8, cell_cap_knn=32,
                       knn_query_chunk=1024))
CFG = CFG.replace(adaptive=dataclasses.replace(CFG.adaptive, use=False))
FRAMES = 10


class _Replay:
    """A captured stretch: ``body`` over the graph's buffers, run again on
    each replay into the outputs of the capture."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for mine, new in zip(graphs._tensors(self.out), graphs._tensors(self.body())):
            mine.copy_(new)


class _NoStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """Graph captures and streams replaced by their stand-ins, the step's
    stretches graphed on the CPU; one thread. A capture runs nothing on
    the device, so the stand-in's run at capture undoes what it wrote into
    the ring and the submap cache."""
    ring = []

    def stretches(state, backend):
        kf = state.keyframes
        ring[:] = [*kf[:6], kf.seq, kf.health, *state[9:13]]
        return pipeline._ring_graphs(state)

    def capture(side, body, counter):
        before = [t.clone() for t in ring]
        out = body()
        for t, b in zip(ring, before):
            t.copy_(b)
        sync.count(counter)
        return _Replay(body, out), out

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "side_stream", lambda dev: _NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(pipeline, "_stretches", stretches)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    sync.reset()
    yield
    torch.set_num_threads(threads)
    sync.reset()


def _scans():
    w = synthetic.make_world(np.random.default_rng(3), n_frames=FRAMES, extent=15.0, n_boxes=6,
                             speed=0.4, ground_points=3000, density=3.0)
    out = []
    for t in range(FRAMES):
        s = synthetic.render_scan(w, t, np.random.default_rng(70 + t), max_range=13.0,
                                  max_points=CFG.shapes.n_raw)
        pts = np.full((CFG.shapes.n_raw, 3), 1e6, np.float32)
        pts[: len(s)] = s
        out.append((torch.from_numpy(pts), torch.from_numpy(np.arange(CFG.shapes.n_raw) < len(s))))
    return out


def _drive(scans, graphed: bool):
    """Each frame's result and the state after it (numpy leaves)."""
    directions = torch.from_numpy(hulls.fibonacci_directions(CFG.shapes.hull_directions))
    state = pipeline.init_frame(CFG, pipeline.fresh_state(CFG, device="cpu"), *scans[0])
    stretches = pipeline._stretches
    if not graphed:
        pipeline._stretches = lambda state, backend: graphs.eager
    try:
        out = []
        for pts, mask in scans[1:]:
            state, res = pipeline.odom_frame(CFG, directions, state, pts, mask, torch.eye(4))
            out.append((res, state_to_numpy(state)))
    finally:
        pipeline._stretches = stretches
    return out


def test_replayed_stretches_give_the_eager_step(stand_in):
    scans = _scans()
    got = _drive(scans, graphed=True)
    counts = dict(sync.counts)
    want = _drive(scans, graphed=False)
    evicted = 0
    for t, ((res, leaves), (res_e, leaves_e)) in enumerate(zip(got, want)):
        for name, value in res._asdict().items():
            other = getattr(res_e, name)
            if isinstance(value, torch.Tensor):
                assert torch.equal(value, other), (t, name)
            else:
                assert value == other, (t, name)
        assert leaves.keys() == leaves_e.keys()
        for k in leaves:
            np.testing.assert_array_equal(leaves[k], leaves_e[k], err_msg=f"frame {t}: {k}")
        evicted += bool(res.kf_evicted)
    # frames spawned, evicted and rebuilt the submap; the results of one
    # frame stay as they were after the next (each its own tensors)
    assert evicted > 0 and sum(r.submap_changed for r, _ in got) > 0
    assert not torch.equal(got[0][0].pose, got[-1][0].pose)
    # each stretch captured once (the warm run is the capturing frame's
    # own), then replayed: front, normals, selection, rebuild, decision,
    # spawn, and the hand-on twice (after a spawn it reads the spawn's
    # outputs where they are, else copies of the ring's count and the
    # no-spawn flags)
    assert counts["step_graph.captures"] == counts["step_graph.eager"] == 8, counts
    stretches = 5 * (FRAMES - 1) + sum(r.submap_changed + r.new_keyframe for r, _ in got)
    assert counts["step_graph.replays"] + counts["step_graph.eager"] == stretches, counts
