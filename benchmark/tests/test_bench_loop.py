"""The loop-closure cell on the CPU: a dry run of ``os1_loop_offline`` at
tiny sizes (two short petals, rounds with candidates from the second
petal on), faults planted in the program's round that the check must
catch (a skipped solve, a moved edge, a skipped re-anchoring, every edge
rejected), the port's round against ``reference/loop.py`` on a seeded small
ring, and the route's roads clear of boxes."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import run as brun
from benchmark.reference import loop as ref_loop
from benchmark.traffic import cloverleaf
from direct_lidar_odometry_tpu_torch.config import config_from_dict
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.odometry import loopclosure, state as tstate
from direct_lidar_odometry_tpu_torch.parallel import posegraph

CELL = "os1_loop_offline"
SECONDS = 5.0  # the tiny first pass (17 frames and its rounds) takes ~3 s on two threads
TINY = {
    "config": {"sensor": {"n_beams": 16, "n_azimuth": 192, "max_range": 13.0},
               "world": {"speed_m_per_frame": 0.4, "corridor_m": 7.0},
               "dlo": {"shapes": {"n_raw": 4096, "n_scan": 1024, "n_keyframe": 512,
                                  "max_keyframes": 32, "max_submap_kf": 4, "n_submap_flat": 2048},
                       "adaptive": {"use": False}, "keyframe": {"thresh_dist": 0.3},
                       "posegraph": {"check_every": 4, "min_seq_gap": 8, "loop_radius": 1.5,
                                     "min_index_gap": 2}}},
    "traffic": {"route": {"petals": 2, "petal_frames": 8}, "chunk": 4, "judged_chunks": 2,
                "judged_rounds": 2, "profile_chunks": 1, "profile_from_chunk": 1,
                "warm_chunks": 2},
    # the tiny world's sparse scans leave the S2M minimum less sharp than
    # the cell's own (as in test_bench_harness.py)
    "limits": {"pose_gap_median_m": 0.03},
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def dry_run(monkeypatch):
    """One tiny run; returns (result line, the judged rounds' frames)."""
    rounds = []
    real = ref_loop.judged_frames

    def judged(*args):
        out = real(*args)
        rounds.append(out)
        return out

    monkeypatch.setattr(ref_loop, "judged_frames", judged)
    cell = harness.load_cell(CELL, scale=TINY)
    return brun.run_cell(cell, 2**33 + 17, SECONDS, False, device="cpu"), rounds


def test_dry_run_judges_rounds(monkeypatch):
    res, rounds = dry_run(monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and set(res["metrics"]) == {"frames_per_s", "setup_s"}
    edges = [d for r in rounds for d, _ in r if isinstance(d, ref_loop.EdgeDrive)]
    assert rounds and edges, "no judged round with an accepted loop edge"
    assert harness.forbidden_modules() == []


def _skip_solve(monkeypatch):
    monkeypatch.setattr(posegraph, "refine", lambda graph, iterations=8, **kw: (
        graph.poses, torch.zeros((), dtype=torch.float32)))


def _move_edge(monkeypatch):
    """The first accepted loop edge of every round 5 cm off."""
    real = loopclosure.register_loop_edges

    def moved(*args):
        loops = real(*args)
        first = int(torch.argmax((loops.weight > 0).to(torch.int32)))
        rel = loops.rel.clone()
        rel[first, :3, 3] += 0.05 / np.sqrt(3.0)
        return loops._replace(rel=rel)

    monkeypatch.setattr(loopclosure, "register_loop_edges", moved)


def _reject_edges(monkeypatch):
    """Every loop edge rejected: the round skips its solve and leaves the
    ring as it was."""
    real = loopclosure.register_loop_edges

    def rejected(*args):
        loops = real(*args)
        return loops._replace(weight=torch.zeros_like(loops.weight))

    monkeypatch.setattr(loopclosure, "register_loop_edges", rejected)


def _skip_reanchor(monkeypatch):
    monkeypatch.setattr(loopclosure, "reanchor",
                        lambda state, new_poses: (state, torch.zeros((), dtype=torch.float32)))


@pytest.mark.parametrize("fault", [_skip_solve, _move_edge, _skip_reanchor, _reject_edges],
                         ids=["solve_skipped", "edge_moved_5cm", "reanchor_skipped",
                              "edges_rejected"])
def test_fault_in_the_round_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, rounds = dry_run(monkeypatch)
    assert rounds
    assert res["correct"] is False, res["checks"]


def _ring(seed: int, k: int = 16, count: int = 12):
    """A drifted keyframe ring on a circle: true poses, the ring's estimate
    (drift growing along the chain), spawn health; slots past ``count``
    unused."""
    rng = np.random.default_rng(seed)
    a = np.linspace(0.0, 2 * np.pi, count, endpoint=False)
    true = np.tile(np.eye(4), (k, 1, 1))
    true[:count, 0, 3], true[:count, 1, 3] = 6 * np.cos(a), 6 * np.sin(a)
    for n in range(count):
        c, s = np.cos(a[n] + np.pi / 2), np.sin(a[n] + np.pi / 2)
        true[n, :2, :2] = [[c, -s], [s, c]]
    est = true.copy()
    drift = np.cumsum(rng.normal(scale=0.02, size=(count, 3)), axis=0)
    est[:count, :3, 3] += drift
    yaw = np.cumsum(rng.normal(scale=0.004, size=count))
    for n in range(count):
        c, s = np.cos(yaw[n]), np.sin(yaw[n])
        est[n, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ est[n, :3, :3]
    est = torch.from_numpy(est).to(torch.float32)
    store = tstate.KeyframeStore(
        positions=est[:, :3, 3].contiguous(), quats=se3.rotmat_to_quat(est[:, :3, :3]),
        points=torch.zeros((k, 4, 3)), masks=torch.zeros((k, 4), dtype=torch.bool),
        normals=torch.zeros((k, 4, 3)), normals_valid=torch.zeros((k, 4), dtype=torch.bool),
        count=torch.tensor(count, dtype=torch.int32),
        seq=torch.where(torch.arange(k) < count, torch.arange(k) * 5, -1).to(torch.int32),
        health=torch.from_numpy(rng.uniform(0.01, 0.05, k)).to(torch.float32))
    return store, torch.from_numpy(true).to(torch.float32)


def test_port_round_matches_reference_on_a_seeded_ring(monkeypatch):
    """The port's refine_and_reanchor (loop edges measured as the true
    relative poses) against reference/loop.py from the same pre-round
    ring: the same candidates, refined positions within 1e-4 m."""
    store, true = _ring(3)
    pg = {"use": True, "loop_radius": 7.0, "min_index_gap": 4, "min_seq_gap": 20, "max_loops": 4,
          "iterations": 8, "chain_weight": 1.0, "loop_weight": 2.0}
    cfg = config_from_dict({"posegraph": pg, "shapes": {"max_keyframes": 16}})

    def measured(store_, edges, mask, cfg_, backend):
        rel = torch.linalg.inv(true[edges[:, 0]]) @ true[edges[:, 1]]
        w = torch.where(mask, 2.0, 0.0)
        return loopclosure.LoopEdges(edges, mask, torch.where(mask[:, None, None], rel, torch.eye(4)),
                                     w, mask.to(torch.int32) * 500)

    monkeypatch.setattr(loopclosure, "register_loop_edges", measured)
    pre = tstate.KeyframeStore(*(t.clone() for t in store))
    state = tstate.OdomState(*(torch.eye(4) if f in ("pose", "t_s2s", "last_delta") else None
                               for f in tstate.OdomState._fields))._replace(
        keyframes=store, submap_members=torch.zeros(16, dtype=torch.bool))
    edges, mask = loopclosure.loop_candidates(pre, 7.0, 4, 4, min_seq_gap=20)
    new, info = loopclosure.refine_and_reanchor(state, cfg, "brute")
    assert info.n_accepted >= 2
    sure, maybe, least = ref_loop.candidates(pre.positions, pre.seq, 12, pg)
    port = {tuple(e) for e, m in zip(edges.tolist(), mask.tolist()) if m}
    assert sure <= port <= maybe and least <= len(port) == info.n_candidates
    loops = measured(None, edges, mask, None, None)
    ref = ref_loop.refine_ring(pre.positions, pre.quats, pre.seq, pre.health, 12,
                               [(i, j, loops.rel[e], 2.0) for e, (i, j) in enumerate(edges.tolist())
                                if mask[e]], pg)
    got = new.keyframes.positions[:12].to(torch.float64)
    assert float((got - ref[:, :3, 3]).norm(dim=1).max()) < 1e-4
    moved = float((got - pre.positions[:12].to(torch.float64)).norm(dim=1).max())
    assert moved > 0.05  # the round really moved the ring


def test_route_puts_no_box_on_the_road():
    """The cell's full cloverleaf: 1201 frames from the hub back to it, four
    petals of radius 300 m / 2 pi, no static box within half the corridor
    of any route pose."""
    cell = harness.load_cell(CELL)
    wcfg, route = cell.config["world"], cell.traffic["route"]
    world = cloverleaf.build_cloverleaf(wcfg, route, np.random.SeedSequence(1))
    xy = world.poses[:, :2, 3]
    assert len(xy) == 1201 and np.allclose(xy[0], 0) and np.allclose(xy[-1], 0, atol=1e-9)
    r = 300 / (2 * np.pi)
    for p in range(4):
        petal = xy[300 * p: 300 * (p + 1)]
        centre = petal.mean(axis=0)
        assert np.allclose(np.linalg.norm(petal - centre, axis=1), r, atol=1e-6)
        assert np.isclose(np.linalg.norm(centre), r)
    assert len(world.boxes) > 1000
    assert cloverleaf.off_road(world.boxes.astype(np.float64), xy, wcfg["corridor_m"] / 2).all()
