"""Parity of the port's K4 (expansion 1-NN), K5 (exhaustive 1-NN) and K6
(exhaustive moments) with the JAX package's Pallas kernels in interpret
mode, and of the runner on the ``pallas_mxu`` backend with the JAX runner.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
kernels themselves are held against those on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu.ops import morton as jmorton, pallas_cov, pallas_nn
from direct_lidar_odometry_tpu.registration import covariance as jcov
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton as tmorton
from direct_lidar_odometry_tpu_torch.registration import covariance as tcov
from tests.test_pallas_e2e import _ate, _scans, pallas_cfg, sparse_world  # noqa: F401
from tests.test_torch_kernels import _sorted_cloud, _t

SLACK = 2e-3  # m^2, the expansion's cancellation slack (tests/test_pallas.py:50-76)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(3)
    tp, tm = _sorted_cloud(rng, 4096)
    qp, qm = _sorted_cloud(rng, 2048)
    return tp, tm, qp, qm


@pytest.mark.parametrize("radius", [0.5, 0.8, 1.5])
def test_query_1nn_sorted_mxu_matches_reference(clouds, radius):
    """K4 against the JAX package's MXU kernel and against the exact search,
    with the slack of tests/test_pallas.py: found may differ only on the
    r^2 border, each winner's d2 within the slack of the true nearest, the
    reported d2 exact for the reported index."""
    tp, tm, qp, qm = clouds
    clo, chi = jmorton.chunk_aabbs(jnp.asarray(tp), jnp.asarray(tm), 512)
    i_j, d_j, f_j = map(np.asarray, pallas_nn.query_1nn_sorted(
        jnp.asarray(tp), jnp.asarray(tm), clo, chi, jnp.asarray(qp), jnp.asarray(qm), radius,
        mxu=True))
    tclo, tchi = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    i_m, d_m, f_m = (x.numpy() for x in cuda_nn.query_1nn_sorted(
        _t(tp), _t(tm), tclo, tchi, _t(qp), _t(qm), radius, mxu=True))
    i_e, d_e, f_e = (x.numpy() for x in cuda_nn.query_1nn_sorted(
        _t(tp), _t(tm), tclo, tchi, _t(qp), _t(qm), radius))
    r2 = radius * radius
    for i_x, d_x, f_x in ((i_m, d_m, f_m), (i_j, d_j, f_j)):
        border = np.abs(d_e - r2) < SLACK
        assert (f_e == f_x)[~border].all()
        both = f_e & f_x
        assert both.sum() > 100
        assert np.all(d_x[both] - d_e[both] < SLACK)
        np.testing.assert_allclose(d_x[both], np.sum((qp[both] - tp[i_x[both]]) ** 2, -1),
                                   rtol=1e-5)
    # the two expansion searches against each other: the same slack
    both = f_m & f_j
    assert np.all(np.abs(d_m[both] - d_j[both]) < SLACK)
    assert (i_m[~f_m] == -1).all() and tm[i_m[f_m]].all()


@pytest.mark.parametrize("n_targets,radius", [(4096, 0.4), (1000, 0.8), (2048, 0.3)])
def test_query_1nn_matches_reference(n_targets, radius):
    """K5, the JAX contract: idx and found exact, d2 rtol 1e-6 for every
    query, including the raw nearest d2 beyond the radius."""
    rng = np.random.default_rng(n_targets)
    tp, tm = _sorted_cloud(rng, n_targets)
    qp, qm = _sorted_cloud(rng, 1024)
    i_j, d_j, f_j = map(np.asarray, pallas_nn.query_1nn(
        jnp.asarray(tp), jnp.asarray(tm), jnp.asarray(qp), jnp.asarray(qm), radius))
    i_t, d_t, f_t = (x.numpy() for x in cuda_nn.query_1nn(_t(tp), _t(tm), _t(qp), _t(qm), radius))
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    beyond = qm & ~f_t
    assert beyond.sum() > 10 and np.isfinite(d_t[beyond]).all()
    assert f_t.sum() > 50


def test_query_1nn_all_targets_invalid():
    """+inf and -1 only when every target is invalid."""
    rng = np.random.default_rng(9)
    qp, qm = _sorted_cloud(rng, 256)
    tp = np.full((600, 3), 1e6, np.float32)
    tm = np.zeros(600, bool)
    i_j, d_j, f_j = map(np.asarray, pallas_nn.query_1nn(
        jnp.asarray(tp), jnp.asarray(tm), jnp.asarray(qp), jnp.asarray(qm), 1.0))
    i_t, d_t, f_t = (x.numpy() for x in cuda_nn.query_1nn(_t(tp), _t(tm), _t(qp), _t(qm), 1.0))
    assert np.isinf(d_t).all() and np.isinf(d_j).all()
    assert (i_t == -1).all() and (i_j == -1).all() and not f_t.any() and not f_j.any()


def _contract_case(case):
    """(targets, target mask, queries, query mask, radius) of one boundary
    case of the exhaustive contracts, from a seed."""
    rng = np.random.default_rng(21)
    qp, qm = _sorted_cloud(rng, 256)
    radius = 1.0
    if case == "all_invalid":
        tp, tm = np.full((600, 3), 1e6, np.float32), np.zeros(600, bool)
    elif case == "one_valid":  # every query's neighbour is slot 417
        tp, tm = np.full((600, 3), 1e6, np.float32), np.zeros(600, bool)
        tp[417], tm[417] = qp[qm][0] + np.float32(0.25), True
    elif case == "scattered":  # a quarter valid, at random slots, in no order
        base, _ = _sorted_cloud(rng, 1024, valid_frac=1.0)
        tp, tm = np.full((4096, 3), 1e6, np.float32), np.zeros(4096, bool)
        where = rng.permutation(4096)[:1024]
        tp[where], tm[where] = base, True
    elif case == "duplicates":  # every target twice: the lower index wins
        base, bm = _sorted_cloud(rng, 512)
        tp, tm = np.concatenate([base, base]), np.concatenate([bm, bm])
    else:  # "on_radius": the nearest targets at exactly r (all exact in f32)
        g = np.stack(np.meshgrid(np.arange(8.0), np.arange(8.0), np.arange(4.0),
                                 indexing="ij"), axis=-1).reshape(-1, 3).astype(np.float32)
        tp, tm = g, np.ones(len(g), bool)
        qp, qm, radius = g + np.float32([0.5, 0.0, 0.0]), np.ones(len(g), bool), 0.5
    return tp, tm, qp, qm, radius


@pytest.mark.parametrize("case", ["all_invalid", "one_valid", "scattered", "duplicates",
                                  "on_radius"])
def test_exhaustive_contracts_match_reference(case):
    """K5 and K6 through the public entries against the JAX kernels in
    interpret mode on the boundary cases of their contracts: idx and found
    exact, d2 to rtol 1e-6, counts exact, moments to 1e-4; a neighbour at
    exactly r is counted (inclusive) and not found (strict); the ``stats``
    output counts the valid targets and one chunk scan per query tile and
    512 of them."""
    tp, tm, qp, qm, radius = _contract_case(case)
    i_j, d_j, f_j = map(np.asarray, pallas_nn.query_1nn(
        jnp.asarray(tp), jnp.asarray(tm), jnp.asarray(qp), jnp.asarray(qm), radius))
    i_t, d_t, f_t = (x.numpy() for x in cuda_nn.query_1nn(_t(tp), _t(tm), _t(qp), _t(qm), radius))
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    m_j = np.asarray(pallas_cov.radius_moments(jnp.asarray(tp), jnp.asarray(tm),
                                               jnp.asarray(qp), radius))
    stats = torch.zeros(2, dtype=torch.int32)
    m_t = cuda_cov.cov_exhaustive(_t(tp), _t(tm), _t(qp), radius, stats).numpy()
    np.testing.assert_array_equal(m_t[:, 0], m_j[:, 0])
    np.testing.assert_allclose(m_t, m_j, atol=1e-4)
    n_valid = int(tm.sum())
    assert stats.tolist() == [n_valid, (len(qp) // 128) * -(-n_valid // 512)]
    raw_i, raw_d = cuda_nn.nn1_exhaustive(_t(qp), _t(tp), _t(tm), stats)
    assert stats.tolist() == [n_valid, (len(qp) // 128) * -(-n_valid // 512)]
    if case == "all_invalid":
        assert np.isinf(d_t).all() and (raw_i == -1).all() and not m_t.any()
    elif case == "one_valid":
        assert (raw_i == 417).all() and np.isfinite(d_t).all() and f_t.any()
    elif case == "scattered":
        assert f_t.sum() > 50 and tm[i_t[f_t]].all() and m_t[:, 0].max() > 1
    elif case == "duplicates":
        assert f_t.sum() > 50 and (i_t[f_t] < 512).all()
        assert (m_t[:, 0] % 2 == 0).all()
    else:
        assert not f_t.any() and (d_t == 0.25).all() and (raw_i >= 0).all()
        assert (m_t[qp[:, 0] < 7.0, 0] == 2).all()


@pytest.mark.parametrize("q_total,t_total,n_sms,want", [
    (32768, 65536, 132, 8),    # the scan against the submap: 256 tiles x 8 = 2048 blocks
    (32768, 32768, 132, 8),
    (128, 65536, 132, 128),    # one tile: a split per chunk the cloud could fill
    (128, 1000, 132, 2),       # a ragged cloud of two chunks
    (2048, 0, 132, 1),         # no targets: still one split
    (1 << 20, 65536, 132, 1),  # more tiles than blocks wanted
])
def test_exhaustive_splits(q_total, t_total, n_sms, want):
    """The K5/K6 scan grid: about SCAN_BLOCKS_PER_SM blocks a multiprocessor,
    never more splits than chunks, never fewer than one."""
    assert cuda_nn.exhaustive_splits(q_total, t_total, n_sms) == want


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_radius_moments_matches_reference(radius):
    """K6: counts exact for every query (no query mask), moments to 1e-4."""
    rng = np.random.default_rng(11)
    tp, tm = _sorted_cloud(rng, 2048, extent=6.0)
    qp = tp[rng.permutation(2048)[:1024]]
    m_j = np.asarray(pallas_cov.radius_moments(jnp.asarray(tp), jnp.asarray(tm),
                                               jnp.asarray(qp), radius))
    m_t = cuda_cov.radius_moments(_t(tp), _t(tm), _t(qp), radius).numpy()
    np.testing.assert_array_equal(m_t[:, 0], m_j[:, 0])
    np.testing.assert_allclose(m_t, m_j, atol=1e-4)
    assert m_t[:, 0].mean() > 4


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_estimate_normals_radius_matches_reference(radius):
    """Validity exact; |n . n'| >= 1 - 1e-4 on well-conditioned
    neighbourhoods, in an unsorted cloud (K6 needs no Morton order)."""
    rng = np.random.default_rng(12)
    tp, tm = _sorted_cloud(rng, 2048, extent=5.0)
    perm = rng.permutation(2048)
    tp, tm = tp[perm], tm[perm]
    nj = jcov.estimate_normals_radius(jnp.asarray(tp), jnp.asarray(tm), radius)
    nt = tcov.estimate_normals_radius(_t(tp), _t(tm), radius)
    vj, vt = np.asarray(nj.valid), nt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 100
    m = cuda_cov.radius_moments(_t(tp), _t(tm), _t(tp), radius)
    ev = np.linalg.eigvalsh(cuda_cov.moments_to_cov(m)[0].numpy().astype(np.float64))
    sep = (ev[:, 1] - ev[:, 0]) > 1e-3 * np.maximum(ev[:, 2], 1e-12)
    both = vt & vj & sep
    dots = np.abs(np.sum(nt.normals.numpy() * np.asarray(nj.normals), axis=-1))
    assert dots[both].min() >= 1 - 1e-4


def test_new_wrappers_route_cpu_to_plain_and_count():
    """Each kernel has its own counter; a CPU tensor takes the plain route."""
    rng = np.random.default_rng(13)
    tp, tm = _sorted_cloud(rng, 1024)
    p, m = _t(tp), _t(tm)
    clo, chi = tmorton.chunk_aabbs(p, m, 512)
    for mod in (cuda_nn, cuda_cov, cuda_gicp):
        mod.reset_launches()
    cuda_nn.query_1nn_sorted(p, m, clo, chi, p, m, 1.0, mxu=True)
    cuda_nn.query_1nn(p, m, p, m, 1.0)
    cuda_cov.radius_moments(p, m, p, 1.0)
    assert cuda_nn.mxu_launches == {"cuda": 0, "plain": 1}
    assert cuda_nn.exhaustive_launches == {"cuda": 0, "plain": 1}
    assert cuda_cov.exhaustive_launches == {"cuda": 0, "plain": 1}
    assert cuda_nn.launches == {"cuda": 0, "plain": 0}
    assert cuda_cov.launches == {"cuda": 0, "plain": 0}
    with pytest.raises(ValueError, match="need Q"):
        cuda_nn.query_1nn(p, m, p[:100], m[:100], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cov.radius_moments(p, m, p[::2], 1.0)
    with pytest.raises(ValueError, match="stats"):
        cuda_nn.nn1_exhaustive(p, p, m, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="stats"):
        cuda_cov.cov_exhaustive(p, m, p, 1.0, torch.zeros(3, dtype=torch.int32))


def test_runner_mxu_matches_reference(sparse_world):  # noqa: F811
    """The runner on "pallas_mxu" against the JAX runner on the same backend
    and scans: poses within 5e-3 m, ATE < 0.05 m, the same keyframe
    decisions, every search through K4's route (K2 never runs)."""
    jcfg = pallas_cfg(nn_backend="pallas_mxu")
    scans = _scans(sparse_world, 6)
    ref = JaxRunner(jcfg)
    ref_kf = []
    for t, s in enumerate(scans):
        res = ref.process_scan(s, float(sparse_world.stamps[t]), sync=True)
        ref_kf.append(None if res is None else bool(res.new_keyframe))
    runner = OdometryRunner(tcfg.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    for mod in (cuda_nn, cuda_cov, cuda_gicp):
        mod.reset_launches()
    new_kf = []
    for t, s in enumerate(scans):
        res = runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
        new_kf.append(None if res is None else res.new_keyframe)
    np.testing.assert_allclose(runner.trajectory(), ref.trajectory(), atol=5e-3)
    assert _ate(runner, sparse_world) < 0.05 and _ate(ref, sparse_world) < 0.05
    assert new_kf == ref_kf
    assert cuda_nn.mxu_launches["plain"] > 0
    assert cuda_nn.launches == {"cuda": 0, "plain": 0}
    assert cuda_gicp.launches == {"cuda": 0, "plain": 0}
