"""The port's multi-sequence batched step (``parallel/batched.py``) and the
lane dimension of kernels K1-K4, on the CPU.

- K1-K4's plain versions over B = 3 lanes equal their per-lane calls bit
  for bit, and agree with ``jax.vmap`` of the JAX package's entries
  (interpret mode, the JAX kernels' batched rules) within the tolerances
  of the single-lane kernel tests;
- ``batched_state`` is B fresh states;
- the keyframe decision and ring insert (eviction included) on a batched
  ring equal each lane's single-ring calls;
- the batched step against the JAX package's ``make_batched_fns`` on two
  worlds, and each lane against the port's own single-sequence
  ``odom_frame(hull_masks=None)``, also with lanes that take different
  branches in one step (a spawn in one lane only, the rescue in one lane
  only), and without the S2S polish;
- host reads a step do not grow with B.

The same on "brute" and "hashgrid": ``tests/test_torch_batched_backends.py``;
the kernels' lanes on a card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.io import synthetic as jsyn
from direct_lidar_odometry_tpu.ops import morton as jmorton, pallas_cov, pallas_gicp, pallas_nn
from direct_lidar_odometry_tpu.parallel import batched as jbatched
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline as tpipe
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton as tmorton
from direct_lidar_odometry_tpu_torch.parallel import batched
from direct_lidar_odometry_tpu_torch.registration import gicp as tgicp
from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS
from direct_lidar_odometry_tpu_torch.utils import sync
from tests.test_pallas_e2e import SCAN_RANGE, pallas_cfg
from tests.test_pallas_gicp import _make_problem
from tests.test_torch_kernels import _sorted_cloud, _t

LANES = 3
N_FRAMES = 5
TIE = 2.0**-14
SLACK = 2e-3  # m^2, K4's expansion slack (tests/test_torch_search.py)


@pytest.fixture(scope="module")
def lanes():
    """LANES Morton-sorted (targets, queries) pairs, numpy, stacked."""
    rng = np.random.default_rng(11)
    parts = [(*_sorted_cloud(rng, 2048), *_sorted_cloud(rng, 1024)) for _ in range(LANES)]
    return [np.stack(x) for x in zip(*parts)]


@pytest.fixture(scope="module")
def problems():
    """LANES fused-linearization problems (tests/test_pallas_gicp.py), a
    pose each: numpy (targets..., p_t, m0, qw) stacked along the lanes."""
    out = []
    for seed in range(LANES):
        source, target = _make_problem(np.random.default_rng(20 + seed))
        tau = np.asarray([0.004, -0.002, 0.003, 0.05, -0.04, 0.02], np.float32) * (seed + 1)
        from direct_lidar_odometry_tpu.core import se3 as jse3

        x = jse3.se3_exp(jnp.asarray(tau))
        out.append((target.points, target.mask, target.normals, target.normals_valid,
                    target.chunk_lo, target.chunk_hi,
                    jse3.transform_points(x, source.points), source.normals @ x[:3, :3].T,
                    source.mask & source.normals_valid))
    return [np.stack([np.asarray(a) for a in x]) for x in zip(*out)]


def _port_lanes(lanes):
    tp, tm, qp, qm = (_t(a) for a in lanes)
    clo, chi = tmorton.chunk_aabbs(tp, tm, 512)
    return tp, tm, clo, chi, qp, qm


def _k3(args, radius=0.5):
    tp, tm, tn, tv, clo, chi, p, m, qw = args
    seed = torch.full(qw.shape, -1, dtype=torch.int32)
    return cuda_gicp.fused_linearize_pruned(p, m, qw, seed, tp, tm, tn, tv, clo, chi, radius,
                                            PLANE_EPS)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_plain_lanes_equal_per_lane_calls(lanes, problems, kernel):
    """A B-lane call of each wrapper (the plain route) equals its per-lane
    calls bit for bit; for K3 the row sums of the public entry too (each
    lane's rows are summed as an unbatched launch's)."""
    if kernel == "K3":
        args = [_t(a) for a in problems]
        got = _k3(args)
        for b in range(LANES):
            one = _k3([a[b] for a in args])
            for x, y in zip(got, one):
                assert torch.equal(x[b], y)
        fl = cuda_gicp.fused_linearize(*args[:6], *args[6:], 0.5, PLANE_EPS)
        for b in range(LANES):
            alone = cuda_gicp.fused_linearize(*(a[b:b + 1] for a in args), 0.5, PLANE_EPS)
            for x, y in zip(fl, alone):
                assert torch.equal(x[b], y[0])
        assert int(fl.n_corr.min()) > 100
        return
    tp, tm, clo, chi, qp, qm = _port_lanes(lanes)
    visits = torch.zeros((LANES, qp.shape[1] // 32), dtype=torch.int32)
    if kernel == "K1":
        got = (cuda_cov.cov_pruned(tp, tm, qp, qm, clo, chi, 0.9, visits),)
        per = [(cuda_cov.cov_pruned(tp[b], tm[b], qp[b], qm[b], clo[b], chi[b], 0.9),)
               for b in range(LANES)]
    else:
        fn = cuda_nn.nn1_pruned if kernel == "K2" else cuda_nn.nn1_pruned_mxu
        got = fn(qp, qm, tp, tm, clo, chi, 0.8, visits)
        per = [fn(qp[b], qm[b], tp[b], tm[b], clo[b], chi[b], 0.8) for b in range(LANES)]
    for b in range(LANES):
        for x, y in zip(got, per[b]):
            assert torch.equal(x[b], y)
        v = torch.zeros(qp.shape[1] // 32, dtype=torch.int32)
        select = cuda_nn.expansion_candidates if kernel == "K4" else cuda_nn.subtile_candidates
        v.copy_(select(qp[b], qm[b], clo[b], chi[b], 0.9 if kernel == "K1" else 0.8).sum(1))
        assert torch.equal(visits[b], v)


def _vmapped(fn, *args):
    return jax.vmap(fn)(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_plain_lanes_match_vmapped_reference(lanes, problems, kernel):
    """B = 3 lanes through the port against ``jax.vmap`` of the JAX
    package's entries (its batched kernel rules, interpret mode), with the
    single-lane tests' tolerances (tests/test_torch_kernels.py,
    test_torch_search.py, test_torch_fused.py)."""
    if kernel == "K3":
        def one(tp, tm, tn, tv, lo, hi, p, m, qw):
            r = pallas_gicp.fused_linearize(tp, tm, tn, tv, lo, hi, p, m, qw, 0.5, PLANE_EPS)
            return r.h, r.b, r.error, r.n_corr, r.corr

        h, bvec, err, n_corr, corr = (np.asarray(a) for a in _vmapped(one, *problems))
        got = cuda_gicp.fused_linearize(*(_t(a) for a in problems), 0.5, PLANE_EPS)
        for b in range(LANES):
            same = corr[b] == got.corr[b].numpy()
            assert same.mean() > 0.99
            np.testing.assert_allclose(got.h[b].numpy(), h[b], rtol=2e-4, atol=2e-3)
            np.testing.assert_allclose(got.b[b].numpy(), bvec[b], rtol=2e-4, atol=2e-3)
            np.testing.assert_allclose(float(got.error[b]), float(err[b]), rtol=2e-4)
            assert abs(int(got.n_corr[b]) - int(n_corr[b])) <= int((~same).sum())
        return
    tp_n, tm_n, qp_n, qm_n = lanes
    tp, tm, clo, chi, qp, qm = _port_lanes(lanes)
    jclo, jchi = jax.vmap(lambda p, m: jmorton.chunk_aabbs(p, m, 512))(
        jnp.asarray(tp_n), jnp.asarray(tm_n))
    if kernel == "K1":
        m_j = np.asarray(jax.vmap(lambda p, m, lo, hi, q, qm: pallas_cov.radius_moments_sorted(
            p, m, lo, hi, q, qm, 0.9))(jnp.asarray(tp_n), jnp.asarray(tm_n), jclo, jchi,
                                      jnp.asarray(qp_n), jnp.asarray(qm_n)))
        m_t = cuda_cov.radius_moments_sorted(tp, tm, clo, chi, qp, qm, 0.9).numpy()
        np.testing.assert_allclose(m_t[qm_n], m_j[qm_n], atol=1e-4)
        return
    mxu = kernel == "K4"
    i_j, d_j, f_j = (np.asarray(a) for a in jax.vmap(
        lambda p, m, lo, hi, q, qm: pallas_nn.query_1nn_sorted(p, m, lo, hi, q, qm, 0.8, mxu=mxu))(
            jnp.asarray(tp_n), jnp.asarray(tm_n), jclo, jchi, jnp.asarray(qp_n),
            jnp.asarray(qm_n)))
    i_t, d_t, f_t = (x.numpy() for x in cuda_nn.query_1nn_sorted(tp, tm, clo, chi, qp, qm, 0.8,
                                                                  mxu=mxu))
    for b in range(LANES):
        assert f_t[b].sum() > 100
        if mxu:
            both = f_t[b] & f_j[b]
            border = np.abs(d_t[b] - 0.64) < SLACK
            assert ((f_t[b] == f_j[b]) | border).all()
            assert np.all(np.abs(d_t[b][both] - d_j[b][both]) < SLACK)
        else:
            assert (f_t[b] == f_j[b]).all()
            f = f_t[b]
            np.testing.assert_allclose(d_t[b][f], d_j[b][f], rtol=1e-6)
            tie = np.abs(d_t[b][f] - d_j[b][f]) <= TIE * d_j[b][f]
            assert ((i_t[b][f] == i_j[b][f]) | tie).all()
        assert tm_n[b][i_t[b][f_t[b]]].all()


def test_batched_state_is_stacked_fresh_states():
    cfg = tcfg.config_from_dict(dataclasses.asdict(pallas_cfg()))
    st = batched.batched_state(cfg, LANES, device="cpu")
    one = tpipe.fresh_state(cfg, device="cpu")
    assert st.submap_grid is None
    for name, value in one._asdict().items():
        if name == "submap_grid":
            continue
        pairs = zip(value, getattr(st, name)) if name == "keyframes" else [(value, getattr(st, name))]
        for a, b in pairs:
            assert b.shape == (LANES,) + a.shape
            assert all(torch.equal(b[i], a) for i in range(LANES))
    # lanes are independent storage: the ring is written in place per lane
    st.keyframes.points[0].zero_()
    assert not torch.equal(st.keyframes.points[1], st.keyframes.points[0])


@pytest.mark.parametrize("count", [3, 16])
def test_ring_updates_on_lanes_equal_single_rings(count):
    """``keyframes.decide`` and ``insert`` on a batched ring of B = 3
    lanes, into every lane and into lanes 2 and 0 only, equal each lane's
    own single-ring calls bit for bit; at ``count`` = 16 the rings are full
    and every insert evicts."""
    from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud
    from direct_lidar_odometry_tpu_torch.odometry import keyframes as tkf
    from direct_lidar_odometry_tpu_torch.registration.covariance import Normals
    from tests.test_torch_odometry import _kf_store_pair, _ring

    rings = []
    for b in range(LANES):
        pos, _ = _ring(30 + b, count=16)
        pos[11] = pos[4 + b] + 0.01  # an unambiguous densest pair
        rings.append(_kf_store_pair(pos, count)[1])
    rng = np.random.default_rng(31)
    near = np.stack([r.positions[4].numpy() for r in rings])
    new_pos = _t(near + rng.normal(size=(LANES, 3)).astype(np.float32))
    quat = rng.normal(size=(LANES, 4)).astype(np.float32)
    quat = _t(quat / np.linalg.norm(quat, axis=1, keepdims=True))
    cloud = PointCloud(_t(rng.normal(size=(LANES, 8, 3)).astype(np.float32)),
                       torch.ones((LANES, 8), dtype=torch.bool))
    nrm = Normals(_t(rng.normal(size=(LANES, 8, 3)).astype(np.float32)), cloud.mask.clone())
    seq = torch.tensor([40, 41, 42], dtype=torch.int32)
    health = torch.tensor([0.25, 0.5, 0.75])
    thresh = torch.tensor([1.0, 2.0, 0.5])

    def stack():
        return type(rings[0])(*(torch.stack([r[i].clone() for r in rings])
                                for i in range(len(rings[0]))))

    dec = tkf.decide(stack(), new_pos, quat, thresh, 45.0)
    for b, ring in enumerate(rings):
        one = tkf.decide(ring, new_pos[b], quat[b], thresh[b], 45.0)
        for x, y in zip(dec, one):
            assert torch.equal(x[b], y)
    for lanes in (None, torch.tensor([2, 0])):
        picked = range(LANES) if lanes is None else lanes.tolist()
        rows = torch.arange(LANES) if lanes is None else lanes
        got, evicted, slot = tkf.insert(
            stack(), new_pos[rows], quat[rows], PointCloud(cloud.points[rows], cloud.mask[rows]),
            Normals(nrm.normals[rows], nrm.valid[rows]), seq=seq[rows], health=health[rows],
            lanes=lanes)
        assert bool(evicted.all()) == (count == 16)
        for i, b in enumerate(picked):
            ring = type(rings[b])(*(t.clone() for t in rings[b]))
            one, ev, sl = tkf.insert(ring, new_pos[b], quat[b],
                                     PointCloud(cloud.points[b], cloud.mask[b]),
                                     Normals(nrm.normals[b], nrm.valid[b]), seq=seq[b],
                                     health=health[b])
            assert (bool(evicted[i]), int(slot[i])) == (bool(ev), int(sl))
            for x, y in zip(got, one):
                assert torch.equal(x[b], y)
        for b in set(range(LANES)) - set(picked):
            for x, y in zip(got, rings[b]):
                assert torch.equal(x[b], y)


# --- the batched step -------------------------------------------------------

def _world(seed):
    # sparse_world's recipe (tests/test_pallas_e2e.py), one seed a lane
    return jsyn.make_world(np.random.default_rng(seed), n_frames=10, extent=15.0, n_boxes=6,
                           speed=0.4, ground_points=3000, density=3.0)


def _render(world, t, seed, noise=0.01):
    return jsyn.render_scan(world, t, np.random.default_rng(seed), max_range=SCAN_RANGE,
                            max_points=4096, noise=noise)


def _stack(scans, n_raw):
    """[B] numpy scans -> padded (points [B, n_raw, 3], mask [B, n_raw])."""
    pts = np.full((len(scans), n_raw, 3), 1e6, np.float32)
    mask = np.zeros((len(scans), n_raw), bool)
    for b, s in enumerate(scans):
        pts[b, :len(s)] = s[:n_raw]
        mask[b, :len(s)] = True
    return pts, mask


def _port_cfg(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


def _port_batched(cfg, frames):
    """The port's batched drive over ``frames`` ([T] lists of [B] scans):
    FrameResults, host reads a step and the rescue's active lanes a step."""
    init_fn, step_fn = batched.make_batched_fns(cfg)
    b = len(frames[0])
    st = batched.batched_state(cfg, b, device="cpu")
    st = init_fn(st, *(_t(a) for a in _stack(frames[0], cfg.shapes.n_raw)))
    eye = torch.eye(4).expand(b, 4, 4).clone()
    results, reads = [], []
    for scans in frames[1:]:
        before = sync.counts["host_reads"]
        st, res = step_fn(st, *(_t(a) for a in _stack(scans, cfg.shapes.n_raw)), eye)
        reads.append(sync.counts["host_reads"] - before)
        results.append(res)
    return results, reads


def _port_single(cfg, scans):
    """One lane through the single-sequence step with the device hull
    surrogates: FrameResults and host reads a frame."""
    directions = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions))
    st = tpipe.fresh_state(cfg, device="cpu")
    raw = tcloud.from_numpy(scans[0], cfg.shapes.n_raw, "cpu")
    st = tpipe.init_frame(cfg, st, raw.points, raw.mask)
    results, reads = [], []
    for s in scans[1:]:
        raw = tcloud.from_numpy(s, cfg.shapes.n_raw, "cpu")
        before = sync.counts["host_reads"]
        st, res = tpipe.odom_frame(cfg, directions, st, raw.points, raw.mask, torch.eye(4),
                                   hull_masks=None)
        reads.append(sync.counts["host_reads"] - before)
        results.append(res)
    return results, reads


def _assert_lane_equals_single(batched_res, b, single_res):
    """Lane b follows its single run bit for bit: the batched step computes
    each lane's sums and pose products in the single step's operations."""
    for rb, rs in zip(batched_res, single_res):
        assert torch.equal(rb.pose[b], rs.pose)
        assert torch.equal(rb.s2m_error[b], rs.s2m_error)
        assert int(rb.s2s_iterations[b]) == rs.s2s_iterations
        assert int(rb.s2m_iterations[b]) == rs.s2m_iterations
        assert bool(rb.new_keyframe[b]) == rs.new_keyframe
        assert bool(rb.submap_changed[b]) == rs.submap_changed
        assert int(rb.num_keyframes[b]) == int(rs.num_keyframes)


@pytest.fixture(scope="module")
def two_worlds():
    worlds = [_world(0), _world(1)]
    frames = [[_render(w, t, 50 + t + 100 * b) for b, w in enumerate(worlds)]
              for t in range(N_FRAMES)]
    return worlds, frames


@pytest.fixture(scope="module")
def port_drive(two_worlds):
    _, frames = two_worlds
    cfg = _port_cfg(pallas_cfg())
    return cfg, _port_batched(cfg, frames)


def _ate(positions, world):
    gt = (np.linalg.inv(world.poses[0])[None] @ world.poses[1:N_FRAMES])[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((positions - gt) ** 2, axis=-1))))


def test_batched_step_matches_jax_make_batched_fns(two_worlds, port_drive):
    """B = 2 lanes, 5 frames: the port's batched step against the JAX
    package's vmapped step on the same raw scans: positions within 5e-3 m,
    the same spawn decisions per lane, ATE < 0.05 m for both."""
    worlds, frames = two_worlds
    _, (port_res, _) = port_drive
    jcfg = pallas_cfg()
    init_fn, step_fn = jbatched.make_batched_fns(jcfg)
    st = init_fn(jbatched.batched_state(jcfg, 2),
                 *(jnp.asarray(a) for a in _stack(frames[0], jcfg.shapes.n_raw)))
    eye = jnp.tile(jnp.eye(4, dtype=jnp.float32), (2, 1, 1))
    jres = []
    for scans in frames[1:]:
        st, res = step_fn(st, *(jnp.asarray(a) for a in _stack(scans, jcfg.shapes.n_raw)), eye)
        jres.append(jax.tree_util.tree_map(np.asarray, res))
    for rp, rj in zip(port_res, jres):
        np.testing.assert_allclose(rp.position.numpy(), rj.position, atol=5e-3)
        np.testing.assert_array_equal(rp.new_keyframe.numpy(), rj.new_keyframe)
    for b, w in enumerate(worlds):
        assert _ate(np.stack([r.position[b].numpy() for r in port_res]), w) < 0.05
        assert _ate(np.stack([r.position[b] for r in jres]), w) < 0.05


@pytest.fixture(scope="module")
def singles(two_worlds, port_drive):
    """Each lane of ``two_worlds`` through the single-sequence step."""
    _, frames = two_worlds
    cfg = port_drive[0]
    return [_port_single(cfg, [f[b] for f in frames]) for b in range(2)]


def test_each_lane_equals_its_single_sequence_run(port_drive, singles):
    """Each lane against the port's single-sequence odom_frame(hull_masks=
    None) on its own scans: the same poses bit for bit, the same GICP
    iteration counts, spawns and submap changes; the B = 2 step reads no
    more than the slower lane's single run plus two interleaved inner
    iterations."""
    _, (res, reads) = port_drive
    for b, (single_res, _) in enumerate(singles):
        _assert_lane_equals_single(res, b, single_res)
    for t, r in enumerate(reads):
        assert r <= max(s[1][t] for s in singles) + 2


def test_lanes_taking_different_branches(two_worlds, port_drive, singles):
    """One step where the lanes part ways: lane 0 (the first world's lane
    above) moves and spawns, lane 1 stands still in that world (the same
    scan again) and never spawns; at the last step lane 1's scan is
    degraded (0.3 m noise), so its S2M stage takes the rescue while lane
    0's does not. Each lane still equals its own single run, and the rescue
    ran for lane 1 alone."""
    worlds, frames = two_worlds
    w = worlds[0]
    lane0 = [f[0] for f in frames]
    lane1 = [_render(w, 0, 90)] * (N_FRAMES - 1) + [_render(w, 0, 91, noise=0.3)]
    cfg = port_drive[0]
    seen = []
    align = tgicp.align_batched

    def spy(src, target, guess, stage, backend="pallas", active=None, cap=16):
        if active is not None:
            seen.append(list(active[1]))
        return align(src, target, guess, stage, backend, active, cap)

    tgicp.align_batched = spy
    try:
        res, _ = _port_batched(cfg, [[a, b] for a, b in zip(lane0, lane1)])
    finally:
        tgicp.align_batched = align
    spawned = np.stack([r.new_keyframe.numpy() for r in res])
    assert spawned[:, 0].any() and not spawned[:, 1].any()
    assert seen and all(a == [False, True] for a in seen)
    _assert_lane_equals_single(res, 0, singles[0][0])
    _assert_lane_equals_single(res, 1, _port_single(cfg, lane1)[0])


def test_lanes_without_the_s2s_polish_equal_their_single_runs(two_worlds):
    """With ``gicp.s2s_full_polish`` off the S2S plan ends at the coarse
    align (``pipeline.s2s_passes``), in the batched step as in the single
    one: two lanes over three frames each equal their own single-sequence
    run bit for bit."""
    _, frames = two_worlds
    frames = frames[:3]
    base = _port_cfg(pallas_cfg())
    cfg = base.replace(gicp=dataclasses.replace(base.gicp, s2s_full_polish=False))
    assert [stride for stride, _ in tpipe.s2s_passes(cfg)] == [4]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res, _ = _port_batched(cfg, frames)
        for b in range(2):
            _assert_lane_equals_single(res, b, _port_single(cfg, [f[b] for f in frames])[0])
    finally:
        torch.set_num_threads(threads)


def test_host_reads_do_not_grow_with_lanes(two_worlds, port_drive, singles):
    """A B = 1 batched step reads the host as often as the single-sequence
    step; three copies of the same lane read exactly as often as one (the
    first three frames)."""
    _, frames = two_worlds
    cfg = port_drive[0]
    lane = [f[0] for f in frames[:3]]
    one = _port_batched(cfg, [[s] for s in lane])[1]
    three = _port_batched(cfg, [[s, s, s] for s in lane])[1]
    assert one == singles[0][1][:2]
    assert three == one
