"""Loop closure and pose-graph refinement of the port
(``parallel/posegraph.py``, ``odometry/loopclosure.py``, the runner's
``maybe_refine``) against the JAX package on the same seeded inputs: the
edge Jacobians against the f64 numeric oracle of ``tests/test_loopclosure.py``,
``refine`` and ``loop_candidates`` on a drifted keyframe ring,
``register_loop_edges`` (JAX ``backend="pallas"`` in interpret mode, the
port's plain versions on the CPU), and a full round from a state carried
across from the port's runner.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu.core import se3 as jse3
from direct_lidar_odometry_tpu.io import synthetic as jsyn
from direct_lidar_odometry_tpu.odometry import loopclosure as jlc, state as jstate
from direct_lidar_odometry_tpu.parallel import posegraph as jpg
from direct_lidar_odometry_tpu.registration import covariance as jcov
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE
from direct_lidar_odometry_tpu_torch.odometry import loopclosure as tlc, state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.ops import cuda_nn, morton
from direct_lidar_odometry_tpu_torch.parallel import posegraph as tpg
from direct_lidar_odometry_tpu_torch.registration import gicp as tgicp
from direct_lidar_odometry_tpu_torch.utils import sync
from tests.test_loopclosure import _loop_world, _rand_pose, _residual_np, _retract, _rodrigues
from tests.test_pipeline import SCAN_RANGE, tiny_cfg


def _rot_angle(a, b):
    """Angle of a^T b for [..., 3, 3] rotations, radians (f64, atan2: an
    arccos of the trace resolves no angle below ~5e-4 in f32)."""
    r = np.swapaxes(np.asarray(a, np.float64), -1, -2) @ np.asarray(b, np.float64)
    s = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                  r[..., 1, 0] - r[..., 0, 1]], axis=-1)
    return np.arctan2(np.linalg.norm(s, axis=-1) / 2, (np.trace(r, axis1=-2, axis2=-1) - 1) / 2)


def _store_pair(leaves):
    """The same keyframe store for both packages, from numpy leaves."""
    js = jstate.KeyframeStore(**{f: jnp.asarray(v) for f, v in leaves.items()})
    ts = tstate.KeyframeStore(**{f: torch.from_numpy(np.array(v)) for f, v in leaves.items()})
    return js, ts


# ------------------------------------------------------------------ posegraph

@pytest.mark.parametrize("seed", [0, 1])
def test_edge_jacobians_match_numdiff(seed):
    """Analytic J_i, J_j against central differences of the f64 oracle
    (the budget of tests/test_loopclosure.py:62), and equal to JAX's."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        x_i, x_j = _rand_pose(rng), _rand_pose(rng)
        z = _retract(np.linalg.inv(x_i) @ x_j, rng.normal(scale=0.03, size=6))
        args32 = [np.asarray(a, np.float32) for a in (x_i, x_j, z)]
        r, j_i, j_j = (t.numpy() for t in tpg.edge_jacobians(*map(torch.from_numpy, args32)))
        np.testing.assert_allclose(r, _residual_np(x_i, x_j, z), atol=1e-5)
        eps = 1e-6
        num_i, num_j = np.zeros((6, 6)), np.zeros((6, 6))
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            num_i[:, k] = (_residual_np(_retract(x_i, d), x_j, z)
                           - _residual_np(_retract(x_i, -d), x_j, z)) / (2 * eps)
            num_j[:, k] = (_residual_np(x_i, _retract(x_j, d), z)
                           - _residual_np(x_i, _retract(x_j, -d), z)) / (2 * eps)
        np.testing.assert_allclose(j_i, num_i, atol=5e-3)
        np.testing.assert_allclose(j_j, num_j, atol=5e-3)
        for got, ref in zip((r, j_i, j_j), jpg.edge_jacobians(*map(jnp.asarray, args32))):
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_residual_matches_reference():
    rng = np.random.default_rng(2)
    poses = np.stack([_rand_pose(rng) for _ in range(6)]).astype(np.float32)
    edges = np.array([[0, 1], [1, 2], [3, 5], [4, 0]], np.int32)
    z = np.stack([_retract(np.linalg.inv(poses[i]) @ poses[j], rng.normal(scale=0.05, size=6))
                  for i, j in edges]).astype(np.float32)
    got = tpg.residual(torch.from_numpy(poses), torch.from_numpy(edges).long(), torch.from_numpy(z))
    for m, (e, zm) in enumerate(zip(edges, z)):
        ref = jpg.residual(jnp.asarray(poses), jnp.asarray(e), jnp.asarray(zm))
        np.testing.assert_allclose(got[m].numpy(), np.asarray(ref), atol=1e-5)


def test_normal_system_matches_reference():
    """H, b and the error of a graph whose keyframes repeat across edges (a
    chain, a loop edge twice and once reversed, two masked self-edges as
    the chain's padding makes) against the JAX package's scatter-added
    system; H symmetric bit for bit."""
    rng = np.random.default_rng(5)
    k = 8
    poses = np.stack([_rand_pose(rng) for _ in range(k)]).astype(np.float32)
    edges = np.array([[t, t + 1] for t in range(k - 1)]
                     + [[0, 5], [0, 5], [5, 0], [2, 6], [7, 7], [7, 7]], np.int32)
    z = np.stack([_retract(np.linalg.inv(poses[i]) @ poses[j], rng.normal(scale=0.05, size=6))
                  for i, j in edges]).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, len(edges)).astype(np.float32)
    edge_mask = np.arange(len(edges)) < len(edges) - 2
    leaves = (poses, np.ones(k, bool), edges, z, edge_mask, weights)
    h, b, err = tpg.build_normal_system(tpg.PoseGraph(
        *(torch.from_numpy(np.array(a)) for a in leaves))._replace(
            edges=torch.from_numpy(edges).long()))
    ref = jpg.build_normal_system(jpg.PoseGraph(*map(jnp.asarray, leaves)))
    for got, want in zip((h, b, err), ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
    assert torch.equal(h, h.T)


def _drifted_ring():
    """The drifted 40-keyframe ring with shuffled slots and one exact loop
    edge of tests/test_loopclosure.py:187-251, as numpy leaves."""
    rng = np.random.default_rng(4)
    k, radius = 40, 12.0
    gt = np.zeros((k, 4, 4))
    for t in range(k):
        a = 2 * np.pi * t / k
        gt[t] = np.eye(4)
        gt[t, :3, :3] = _rodrigues(np.array([0, 0, a + np.pi / 2]))
        gt[t, :3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.0]
    gt = np.linalg.inv(gt[0])[None] @ gt
    est = gt.copy()
    drift = np.zeros(3)
    healths = np.full(k, 0.08, np.float32)
    for t in range(12, 20):
        drift += rng.normal(scale=0.02, size=3)
        healths[t] = 0.8
    for t in range(12, k):
        est[t, :3, 3] = gt[t, :3, 3] + drift * min(1.0, (t - 11) / 8.0)
    perm = rng.permutation(k)
    inv_perm = np.argsort(perm)
    quats = np.stack([np.asarray(jse3.rotmat_to_quat(jnp.asarray(est[p, :3, :3], jnp.float32)))
                      for p in perm])
    leaves = dict(
        positions=est[perm, :3, 3].astype(np.float32), quats=quats.astype(np.float32),
        points=np.zeros((k, 4, 3), np.float32), masks=np.zeros((k, 4), bool),
        normals=np.zeros((k, 4, 3), np.float32), normals_valid=np.zeros((k, 4), bool),
        count=np.int32(k), seq=perm.astype(np.int32), health=healths[perm],
    )
    loop = dict(edges=np.array([[inv_perm[0], inv_perm[k - 1]]], np.int32),
                rel=(np.linalg.inv(gt[0]) @ gt[k - 1])[None].astype(np.float32))
    return leaves, loop, gt[perm], est[perm]


def _ring_graphs():
    leaves, loop, gt, est = _drifted_ring()
    js, ts = _store_pair(leaves)
    jl = jlc.LoopEdges(edges=jnp.asarray(loop["edges"]), mask=jnp.asarray([True]),
                       rel=jnp.asarray(loop["rel"]), weight=jnp.asarray([2.0], jnp.float32),
                       num_corr=jnp.asarray([1000], jnp.int32))
    tl = tlc.LoopEdges(edges=torch.from_numpy(loop["edges"]).long(), mask=torch.tensor([True]),
                       rel=torch.from_numpy(loop["rel"]), weight=torch.tensor([2.0]),
                       num_corr=torch.tensor([1000], dtype=torch.int32))
    return jlc.build_refinement_graph(js, jl, 1.0), tlc.build_refinement_graph(ts, tl, 1.0), gt, est


def test_refine_drifted_ring_matches_reference():
    """build_refinement_graph + refine, port vs JAX: the same graph, poses
    within 1e-4 m and 1e-4 rad, graph error within 1e-3 relative, and the
    repair of tests/test_loopclosure.py:249-251 holds in the port."""
    jg, tg, gt, est = _ring_graphs()
    for f in jpg.PoseGraph._fields:
        np.testing.assert_allclose(getattr(tg, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jg, f), np.float64), atol=1e-5, err_msg=f)
    jp, je = jpg.refine(jg, iterations=10)
    tp, te = tpg.refine(tg, iterations=10)
    jp, tp = np.asarray(jp), tp.numpy()
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=1e-4)
    assert _rot_angle(tp[:, :3, :3], jp[:, :3, :3]).max() < 1e-4
    assert abs(float(te) - float(je)) <= 1e-3 * abs(float(je))
    err_before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    err_after = np.linalg.norm(tp[:, :3, 3] - gt[:, :3, 3], axis=-1)
    assert err_after.mean() < 0.7 * err_before.mean(), (err_before.mean(), err_after.mean())
    assert err_after.max() < err_before.max()


def test_odometry_chain_graph_without_seq_matches_reference():
    leaves, _, _, _ = _drifted_ring()
    args = [leaves["positions"], leaves["quats"], np.int32(30)]
    jg = jpg.odometry_chain_graph(*map(jnp.asarray, args), max_edges=36)
    tg = tpg.odometry_chain_graph(*map(torch.from_numpy, map(np.array, args)), max_edges=36)
    for f in jpg.PoseGraph._fields:
        np.testing.assert_allclose(getattr(tg, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jg, f), np.float64), atol=1e-5, err_msg=f)


@pytest.mark.parametrize("radius,gap,max_loops,seq_gap", [
    (6.0, 12, 4, 0), (3.0, 8, 8, 0), (20.0, 12, 16, 0), (20.0, 4, 8, 30),
])
def test_loop_candidates_match_reference(radius, gap, max_loops, seq_gap):
    """The same valid (i, j) pairs in the same order (the masked-out
    entries are unordered in both packages)."""
    js, ts = _store_pair(_drifted_ring()[0])
    je, jm = jlc.loop_candidates(js, radius, gap, max_loops, min_seq_gap=seq_gap)
    te, tm = tlc.loop_candidates(ts, radius, gap, max_loops, min_seq_gap=seq_gap)
    ref = np.asarray(je)[np.asarray(jm)]
    assert len(ref) > 0
    assert te.numpy()[tm.numpy()].tolist() == ref.tolist()


# ---------------------------------------------------------------- loop edges

def _wide_gate_store():
    """The drifted revisit of tests/test_loopclosure.py:254-330, with both
    clouds Morton-sorted (the pruned-kernel backends require it)."""
    rng = np.random.default_rng(7)
    n = 2048
    pts = np.zeros((n, 3), np.float32)
    third = n // 3
    pts[:third, :2] = rng.uniform(-8, 8, (third, 2))
    pts[third:2 * third, 1:] = rng.uniform(-8, 8, (third, 2))
    pts[third:2 * third, 0] = 5.0
    rest = n - 2 * third
    pts[2 * third:, ::2] = rng.uniform(-8, 8, (rest, 2))
    pts[2 * third:, 1] = 5.0
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    sorted_pts, _ = morton.sort_cloud(torch.from_numpy(pts), torch.ones(n, dtype=torch.bool))
    pts = sorted_pts.numpy()
    nrm = jcov.estimate_normals_brute(jnp.asarray(pts), jnp.ones((n,), bool), k=10, chunk=1024)
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [1.2, -0.4, 0.1]
    pts_j = (pts @ drift[:3, :3].T + drift[:3, 3]).astype(np.float32)
    kc = 4
    leaves = dict(
        positions=np.stack([np.zeros(3), drift[:3, 3], np.zeros(3), np.zeros(3)]).astype(np.float32),
        quats=np.tile(np.array([1.0, 0, 0, 0], np.float32), (kc, 1)),
        points=np.stack([pts, pts_j, pts, pts]), masks=np.ones((kc, n), bool),
        normals=np.stack([np.asarray(nrm.normals)] * kc),
        normals_valid=np.stack([np.asarray(nrm.valid)] * kc),
        count=np.int32(2), seq=np.arange(kc, dtype=np.int32), health=np.zeros(kc, np.float32),
    )
    cfg = DloConfig().replace(nn_backend="pallas", shapes=ShapeConfig(
        n_scan=n, n_keyframe=n, max_keyframes=kc, grid_table_size=2**12, submap_table_size=2**12))
    return leaves, cfg


@pytest.mark.parametrize("gate", ["wide", "tight"])
def test_register_loop_edges_matches_reference(gate):
    """JAX (pallas, interpret mode) vs the port (plain versions): equal
    weights and correspondence counts, rel within 1e-4 m and 1e-4 rad, a
    masked-out edge gives identity / 0 / 0. The wide gate measures the
    drift; the tight 0.5 m gate does not."""
    leaves, cfg = _wide_gate_store()
    if gate == "tight":
        cfg = dataclasses.replace(cfg, posegraph=dataclasses.replace(
            cfg.posegraph, loop_corr_distance=0.5, loop_max_iterations=32))
    js, ts = _store_pair(leaves)
    edges = np.array([[0, 1], [2, 3]], np.int32)
    mask = np.array([True, False])
    jr = jlc.register_loop_edges(js, jnp.asarray(edges), jnp.asarray(mask), cfg, "pallas")
    cuda_nn.reset_launches()
    tr = tlc.register_loop_edges(ts, torch.from_numpy(edges).long(), torch.from_numpy(mask),
                                 tcfg.config_from_dict(dataclasses.asdict(cfg)), "pallas")
    assert cuda_nn.launches["plain"] > 0 and cuda_nn.launches["cuda"] == 0
    np.testing.assert_array_equal(tr.weight.numpy(), np.asarray(jr.weight))
    np.testing.assert_array_equal(tr.num_corr.numpy()[:1], np.asarray(jr.num_corr)[:1])
    rel_t, rel_j = tr.rel.numpy(), np.asarray(jr.rel)
    np.testing.assert_allclose(rel_t[0, :3, 3], rel_j[0, :3, 3], atol=1e-4)
    assert _rot_angle(rel_t[0, :3, :3], rel_j[0, :3, :3]) < 1e-4
    np.testing.assert_array_equal(rel_t[1], np.eye(4))
    assert float(tr.weight[1]) == 0.0 and int(tr.num_corr[1]) == 0
    if gate == "wide":
        assert float(tr.weight[0]) > 0 and np.linalg.norm(rel_t[0, :3, 3]) < 0.05
    elif float(tr.weight[0]) > 0:
        assert np.linalg.norm(rel_t[0, :3, 3]) > 0.3, rel_t[0]


# ------------------------------------------------------ full round, carried state

N_LOOP = 40


@pytest.fixture(scope="module")
def loop_round():
    """The port's runner (CPU, pallas, posegraph on) over the 40-frame loop
    world of tests/test_loopclosure.py with the config of :360-369 at small
    shapes; its state is carried into JAX's refine_and_reanchor, and the
    port's maybe_refine(force=True) runs on the same state."""
    base = tiny_cfg()
    cfg = dataclasses.replace(
        base, nn_backend="pallas",
        shapes=dataclasses.replace(base.shapes, n_raw=4096, n_scan=4096, n_keyframe=2048,
                                   max_keyframes=32, max_submap_kf=4, n_submap_flat=4096),
        posegraph=dataclasses.replace(base.posegraph, use=True, min_index_gap=4, loop_radius=4.0,
                                      refine_every_kf=3, check_every=64, min_loop_corr=100),
        keyframe=dataclasses.replace(base.keyframe, thresh_dist=1.0),
        adaptive=dataclasses.replace(base.adaptive, use=False),
    )
    world = _loop_world(N_LOOP)
    rng = np.random.default_rng(3)
    runner = OdometryRunner(tcfg.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    for t in range(N_LOOP):
        scan = jsyn.render_scan(world, t, rng, max_range=SCAN_RANGE, max_points=4096)
        runner.process_scan(scan, float(world.stamps[t]))
    before = tstate.state_to_numpy(runner.state)
    jkf = jstate.KeyframeStore(**{f: jnp.asarray(before[f"keyframes.{f}"])
                                  for f in jstate.KeyframeStore._fields})
    jst = jstate.OdomState(keyframes=jkf, submap_grid=None, **{
        f: jnp.asarray(before[f]) for f in jstate.OdomState._fields
        if f not in ("keyframes", "submap_grid")})
    jnew, jinfo = jlc.refine_and_reanchor(jst, cfg, "pallas")
    # the round's tracing: the aggregates before and after it, and the
    # outer iterations of every align it ran
    align, iters = tgicp.align, []

    def counted(*args, **kw):
        res = align(*args, **kw)
        iters.append(int(res.iterations))
        return res

    before_totals = sync.totals()
    tgicp.align = counted
    try:
        info = runner.maybe_refine(force=True)
    finally:
        tgicp.align = align
    return dict(runner=runner, world=world, rng=rng, before=before, info=info,
                after=tstate.state_to_numpy(runner.state), jnew=jnew, jinfo=jinfo,
                totals=(before_totals, sync.totals()), align_iters=iters)


def test_refine_round_from_carried_state_matches_reference(loop_round):
    """Same candidate and accepted counts; keyframe poses, masked keyframe
    points, pose and t_s2s within 1e-4; pad rows untouched; the cached
    submap's members cleared."""
    info, jinfo, after, jnew = (loop_round[k] for k in ("info", "jinfo", "after", "jnew"))
    assert info is not None and info["n_candidates"] >= 1
    assert info["n_candidates"] == int(jinfo.n_candidates)
    assert info["n_accepted"] == int(jinfo.n_accepted) >= 1
    assert info["graph_error"] == pytest.approx(float(jinfo.graph_error), rel=1e-3)
    assert info["max_correction_m"] == pytest.approx(float(jinfo.max_correction), abs=1e-4)
    for f in ("positions", "quats"):
        np.testing.assert_allclose(after[f"keyframes.{f}"], np.asarray(getattr(jnew.keyframes, f)),
                                   atol=1e-4, err_msg=f)
    m = after["keyframes.masks"]
    np.testing.assert_allclose(after["keyframes.points"][m],
                               np.asarray(jnew.keyframes.points)[m], atol=1e-4)
    assert np.all(after["keyframes.points"][~m] == PAD_VALUE)
    np.testing.assert_allclose(after["pose"], np.asarray(jnew.pose), atol=1e-4)
    np.testing.assert_allclose(after["t_s2s"], np.asarray(jnew.t_s2s), atol=1e-4)
    assert not after["submap_members"].any() and not np.asarray(jnew.submap_members).any()
    # the keyframes actually moved, and only the occupied slots
    kc = int(after["keyframes.count"])
    moved = np.abs(after["keyframes.positions"] - loop_round["before"]["keyframes.positions"])
    assert moved[:kc].max() > 0 and moved[kc:].max() == 0


def test_refine_round_records_its_spans_and_counters(loop_round):
    """A forced round records the four stage spans inside ``runner.refine``,
    one round, its registered and accepted edges and the ring's count at
    the solve, and its aligns' outer iterations as
    ``align_iters.refine.register``."""
    (t0, t1), info = loop_round["totals"], loop_round["info"]

    def spans(name):
        return t1.spans.get(name, (0, 0, 0))[0] - t0.spans.get(name, (0, 0, 0))[0]

    def counted(name):
        return t1.counts.get(name, 0) - t0.counts.get(name, 0)

    assert spans("runner.refine") == 1
    for stage in ("refine.candidates", "refine.register", "refine.solve", "refine.reanchor"):
        assert spans(stage) == 1, stage
    assert counted("refine.rounds") == 1
    assert counted("refine.edges_registered") == info["n_candidates"] == len(loop_round["align_iters"])
    assert counted("refine.edges_accepted") == info["n_accepted"] >= 1
    assert counted("refine.live_keyframes") == info["n_keyframes"]
    assert counted("align_iters.refine.register") == sum(loop_round["align_iters"]) > 0


def test_chunks_count_toward_the_trigger_together():
    """``process_chunk``'s frames count toward ``check_every`` as a block
    and the remainder carries over: chunks of 8 against a check every 10
    frames check after the 2nd, 3rd, 4th and 5th chunk (one round per 10
    frames on average); without ``posegraph.use`` nothing is checked."""
    cfg = tcfg.config_from_dict({"posegraph": {"use": True, "check_every": 10}})
    for use, want in ((True, [2, 3, 4, 5, 7]), (False, [])):
        runner = OdometryRunner(cfg.replace(posegraph=dataclasses.replace(cfg.posegraph, use=use)),
                                device="cpu")
        checked = []
        runner.maybe_refine = lambda force=False: checked.append(chunk)
        for chunk in range(1, 8):
            runner._check_refine(8)
        assert checked == want


def test_tracking_continues_after_refine(loop_round):
    """The round is not due again right after it ran, and tracking goes on
    from the re-anchored state (tests/test_loopclosure.py:395-401)."""
    runner, world, rng = loop_round["runner"], loop_round["world"], loop_round["rng"]
    assert runner.maybe_refine() is None
    assert len(runner.refine_log) == 1
    for t in range(5):
        scan = jsyn.render_scan(world, t % N_LOOP, rng, max_range=SCAN_RANGE, max_points=4096)
        res = runner.process_scan(scan, float(world.stamps[-1]) + 0.1 * (t + 1))
        assert runner.health_check(res) != "diverged"
    assert np.isfinite(runner.trajectory()).all()


def test_debug_tool_numpy_oracle_is_the_reference():
    """``tools_torch/debug_loopclosure.py``'s numpy copies of the f64 oracle
    (``_rodrigues``, ``_log_so3``, ``_retract``, ``_residual_np``) equal
    ``tests/test_loopclosure.py``'s on random poses, the small-angle
    branches included."""
    from tests import test_loopclosure as jlct
    from tools_torch import debug_loopclosure as dlc

    rng = np.random.default_rng(4)
    for w in [np.zeros(3), np.full(3, 1e-12)] + [rng.normal(scale=0.8, size=3) for _ in range(6)]:
        np.testing.assert_array_equal(dlc._rodrigues(w), jlct._rodrigues(w))
        np.testing.assert_array_equal(dlc._log_so3(jlct._rodrigues(w)),
                                      jlct._log_so3(jlct._rodrigues(w)))
    for _ in range(6):
        x_i, x_j, z = (_rand_pose(rng) for _ in range(3))
        xi = rng.normal(scale=0.3, size=6)
        np.testing.assert_array_equal(dlc._retract(x_i, xi), jlct._retract(x_i, xi))
        np.testing.assert_array_equal(dlc._residual_np(x_i, x_j, z), _residual_np(x_i, x_j, z))
