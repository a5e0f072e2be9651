"""Parity of the port's fused linearization (kernel K3, ops/cuda_gicp.py)
with the JAX package's ``pallas_gicp.fused_linearize`` (interpret mode),
and of the runner on the ``pallas_fused`` backend with the JAX runner.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
kernel itself is held against that plain version on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Tolerances are those
of ``tests/test_pallas_gicp.py``: correspondences and weights equal except
among near-ties (2^-14 relative: the JAX kernel's centred distance
expansion may order them differently), payload to 1e-6, H and b to
rtol 2e-4 / atol 2e-3 (summation order), the error to rtol 2e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.config import load_config
from direct_lidar_odometry_tpu.core import se3 as jse3
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu.ops import pallas_gicp
from direct_lidar_odometry_tpu.registration import gicp as jgicp
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn
from direct_lidar_odometry_tpu_torch.registration import gicp as tgicp
from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS
from tests.test_pallas_e2e import _ate, _scans, pallas_cfg, sparse_world  # noqa: F401
from tests.test_pallas_gicp import _make_problem

TIE = 2.0**-14


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port_problem(source, target):
    src = tgicp.GicpSource(*(_t(a) for a in source))
    tgt = tgicp.make_target(*(_t(a) for a in (target.points, target.mask, target.normals,
                                               target.normals_valid)))
    return src, tgt


def _pose(tau):
    return np.asarray(jse3.se3_exp(jnp.asarray(tau, jnp.float32)))


def _fused_inputs(source, pose):
    """p_t, m_rot and query weight of the JAX package, as numpy."""
    x = jnp.asarray(pose)
    p_t = np.asarray(jse3.transform_points(x, source.points))
    m0 = np.asarray(source.normals @ x[:3, :3].T)
    qw = np.asarray(source.mask & source.normals_valid)
    return p_t, m0, qw


def _near_tie_ok(corr_a, corr_b, p_t, targets):
    """Differing correspondences are near-ties: both targets at the same
    distance within 2^-14 relative."""
    diff = corr_a != corr_b
    if not diff.any():
        return True
    if ((corr_a < 0) != (corr_b < 0))[diff].any():
        return False
    da = np.sum((p_t[diff] - targets[corr_a[diff]]) ** 2, axis=1)
    db = np.sum((p_t[diff] - targets[corr_b[diff]]) ** 2, axis=1)
    return bool(np.all(np.abs(da - db) <= TIE * np.maximum(da, db)))


def _assert_close_to(ref, got, p_t, targets):
    corr_r, corr_g = np.asarray(ref.corr), got.corr.numpy()
    assert _near_tie_ok(corr_r, corr_g, p_t, targets)
    same = corr_r == corr_g
    np.testing.assert_array_equal(np.asarray(ref.weight)[same], got.weight.numpy()[same])
    w = (np.asarray(ref.weight) > 0.5) & same
    np.testing.assert_allclose(got.mu_b.numpy()[w], np.asarray(ref.mu_b)[w], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.n_b.numpy()[w], np.asarray(ref.n_b)[w], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=2e-4)
    assert abs(int(got.n_corr) - int(ref.n_corr)) <= int((~same).sum())


@pytest.mark.parametrize("seed,seeded", [(0, False), (3, False), (5, True)])
def test_fused_linearize_matches_reference(seed, seeded):
    """Cold and warm-started passes against the JAX kernel on the
    _make_problem world; the seeds come from a different transform (wrong
    but valid upper bounds, the adversarial case)."""
    source, target = _make_problem(np.random.default_rng(seed))
    radius = load_config().gicp.s2m.max_correspondence_distance
    pose = _pose([0.004, -0.002, 0.003, 0.05, -0.04, 0.02])
    seed_pose = _pose([-0.003, 0.002, 0.001, -0.04, 0.05, 0.02])
    p_t, m0, qw = _fused_inputs(source, pose)
    j_seed = t_seed = None
    if seeded:
        ps, ms, _ = _fused_inputs(source, seed_pose)
        j_seed = pallas_gicp.fused_linearize(
            target.points, target.mask, target.normals, target.normals_valid,
            target.chunk_lo, target.chunk_hi, jnp.asarray(ps), jnp.asarray(ms),
            jnp.asarray(qw), radius, PLANE_EPS).corr
        t_seed = _t(np.asarray(j_seed))
    ref = pallas_gicp.fused_linearize(
        target.points, target.mask, target.normals, target.normals_valid,
        target.chunk_lo, target.chunk_hi, jnp.asarray(p_t), jnp.asarray(m0),
        jnp.asarray(qw), radius, PLANE_EPS, seed_corr=j_seed)
    _, tgt = _port_problem(source, target)
    got = cuda_gicp.fused_linearize(
        tgt.points, tgt.mask, tgt.normals, tgt.normals_valid, tgt.chunk_lo, tgt.chunk_hi,
        _t(p_t), _t(m0), _t(qw), radius, PLANE_EPS, seed_corr=t_seed)
    assert int(got.n_corr) > 200
    _assert_close_to(ref, got, p_t, np.asarray(target.points))
    # diagnostics count 32-query sub-tiles: the selection at r, which lies
    # inside the reference's 128-query tile lists (4 sub-tiles a tile)
    cand = cuda_nn.subtile_candidates(_t(p_t), _t(qw), tgt.chunk_lo, tgt.chunk_hi, radius)
    assert float(got.bb_candidates) == float(cand.sum())
    assert float(got.bb_candidates) <= 4 * float(ref.bb_candidates)
    if seeded:
        assert float(got.bb_visits) <= float(got.bb_candidates)
    else:
        assert float(got.bb_visits) == float(got.bb_candidates)


def _fused_plain_run(seed_pose):
    """K3's plain route on the _make_problem world at a fixed pose, cold and
    seeded with the correspondences of ``seed_pose``: (inputs, cold, seeded,
    seed)."""
    source, target = _make_problem(np.random.default_rng(4))
    _, tgt = _port_problem(source, target)
    radius = load_config().gicp.s2m.max_correspondence_distance
    p_t, m0, qw = (_t(a) for a in _fused_inputs(source, _pose([0.004, -0.002, 0.003, 0.05,
                                                                -0.04, 0.02])))
    ps, ms, _ = (_t(a) for a in _fused_inputs(source, _pose(seed_pose)))
    args = (tgt.points, tgt.mask, tgt.normals, tgt.normals_valid, tgt.chunk_lo, tgt.chunk_hi,
            radius, PLANE_EPS)
    cold = torch.full((p_t.shape[0],), -1, dtype=torch.int32)
    _, _, seed = cuda_gicp.fused_linearize_pruned(ps, ms, qw, cold, *args)
    return ((p_t, m0, qw, tgt, radius), cuda_gicp.fused_linearize_pruned(p_t, m0, qw, cold, *args),
            cuda_gicp.fused_linearize_pruned(p_t, m0, qw, seed, *args), seed)


def test_fused_selection_counts_under_a_seed_bound():
    """Slots 29/30 of K3's rows: 30 counts each sub-tile's chunks at r, 29
    the chunks within the sub-tile's bound B (the largest seed d2 of its
    weighted queries, r^2 where one is unseeded), recomputed here in numpy;
    every cold winner lies in a visited chunk of its sub-tile, which is why
    the seeded pass equals the cold one."""
    (p_t, _, qw, tgt, radius), (hb, _, corr), (hs, _, corr_s), seed = _fused_plain_run(
        [0.001, 0.0, -0.001, 0.01, 0.0, -0.01])
    r2 = cuda_nn.f32_radius2(radius)
    gap2 = cuda_nn.subtile_gap2(p_t, qw, tgt.chunk_lo, tgt.chunk_hi).numpy()
    np.testing.assert_array_equal(hb[:, 30].numpy(), (gap2 <= r2).sum(1))
    np.testing.assert_array_equal(hs[:, 30].numpy(), hb[:, 30].numpy())
    np.testing.assert_array_equal(hb[:, 29].numpy(), hb[:, 30].numpy())  # cold: B = r^2
    pts, tmask = tgt.points.numpy(), tgt.mask.numpy()
    j = seed.numpy().astype(np.int64)
    live = qw.numpy() & (j >= 0)
    d = p_t.numpy() - pts[np.where(live, j, 0)]
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    seeded = live & tmask[np.where(live, j, 0)] & (d2 < r2)
    own = np.where(qw.numpy(), np.where(seeded, d2, np.float32(r2)), np.float32(0.0))
    bound = own.reshape(-1, 32).max(axis=1)
    assert seeded.sum() > 100 and (bound < r2).any()
    np.testing.assert_array_equal(hs[:, 29].numpy(), (gap2 <= bound[:, None]).sum(1))
    c = corr.numpy()
    won = c >= 0
    rows = np.nonzero(won)[0] // 32
    assert (gap2[rows, c[won] // 512] <= bound[rows]).all()
    assert torch.equal(corr_s, corr)


@pytest.mark.parametrize("seed_pose", [
    [0.001, 0.0, -0.001, 0.01, 0.0, -0.01],     # near the pose: bounds shrink
    [-0.003, 0.002, 0.001, -0.04, 0.05, 0.02],  # 5 cm away: wrong but valid seeds
])
def test_fused_seeded_visits_at_most_cold(seed_pose):
    """A seed can only shrink K3's selection: per sub-tile the seeded visits
    are at or below the cold ones; everything but slot 29 stays
    bit-identical."""
    _, (hb, pay, corr), (hs, ps, corr_s), _ = _fused_plain_run(seed_pose)
    assert bool((hs[:, 29] <= hb[:, 29]).all())
    assert torch.equal(hs[:, :29], hb[:, :29]) and torch.equal(hs[:, 30:], hb[:, 30:])
    assert torch.equal(ps, pay) and torch.equal(corr_s, corr)


def test_seeded_equals_cold_exactly():
    """The seed only tightens the bound: bit-identical results, including
    all -1 seeds and seeds with the cold answer itself."""
    source, target = _make_problem(np.random.default_rng(5))
    src, tgt = _port_problem(source, target)
    cfg = tcfg.load_config().gicp.s2m
    x_a = _t(_pose([0.002, -0.001, 0.002, 0.03, -0.02, 0.01]))
    x_b = _t(_pose([-0.003, 0.002, 0.001, -0.04, 0.05, 0.02]))
    lin_a = tgicp._linearize(x_a, src, tgt, cfg, "pallas_fused")
    cold = tgicp._linearize(x_b, src, tgt, cfg, "pallas_fused")
    n = src.points.shape[0]
    for seed in (lin_a.corr, cold.corr, torch.full((n,), -1, dtype=torch.int32)):
        warm = tgicp._linearize(x_b, src, tgt, cfg, "pallas_fused", seed_corr=seed)
        for a, b in zip(warm, cold):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_linearize_matches_unfused_path(seed):
    """The port's _linearize on "pallas_fused" against its own "pallas"
    path: same correspondences (both searches are exact with the same tie
    rule), H/b/error within the summation-order tolerances."""
    source, target = _make_problem(np.random.default_rng(seed))
    src, tgt = _port_problem(source, target)
    cfg = tcfg.load_config().gicp.s2m
    x0 = _t(_pose([0.004, -0.002, 0.003, 0.05, -0.04, 0.02]))
    lin_f = tgicp._linearize(x0, src, tgt, cfg, "pallas_fused")
    lin_u = tgicp._linearize(x0, src, tgt, cfg, "pallas")
    assert int(lin_f.n_corr) == int(lin_u.n_corr) > 200
    np.testing.assert_array_equal(lin_f.corr.numpy(), lin_u.corr.numpy())
    np.testing.assert_array_equal(lin_f.weight.numpy(), lin_u.weight.numpy())
    w = lin_f.weight.numpy() > 0.5
    np.testing.assert_allclose(lin_f.mu_b.numpy()[w], lin_u.mu_b.numpy()[w], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lin_f.n_b.numpy()[w], lin_u.n_b.numpy()[w], rtol=0, atol=1e-6)
    for a, b in ((lin_f.h, lin_u.h), (lin_f.b, lin_u.b)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(float(lin_f.error), float(lin_u.error), rtol=2e-4)


def test_fused_align_matches_reference():
    """align() on "pallas_fused" in both packages: transforms to 1e-4,
    iterations and correspondence counts equal."""
    source, target = _make_problem(np.random.default_rng(2))
    cfg = load_config().gicp.s2s
    guess = _pose([0.01, -0.008, 0.005, 0.05, -0.04, 0.03])
    rj = jgicp.align(source, target, jnp.asarray(guess), cfg, cap=32, backend="pallas_fused")
    src, tgt = _port_problem(source, target)
    rt = tgicp.align(src, tgt, _t(guess), tcfg.load_config().gicp.s2s, "pallas_fused")
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), atol=1e-4)
    assert rt.iterations == int(rj.iterations)
    assert int(rt.num_correspondences) == int(rj.num_correspondences)


N_FRAMES = 6


def test_runner_fused_matches_reference(sparse_world):  # noqa: F811
    """The runner on "pallas_fused" against the JAX runner on the same
    backend and scans, as tests/test_torch_e2e.py does for "pallas": poses
    within 5e-3 m, ATE < 0.05 m, the same keyframe decisions, and every
    linearization through K3's route (K2 never runs)."""
    jcfg = pallas_cfg(nn_backend="pallas_fused")
    scans = _scans(sparse_world, N_FRAMES)
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
    assert cuda_gicp.launches["plain"] > 0 and cuda_gicp.launches["cuda"] == 0
    assert cuda_nn.launches == {"cuda": 0, "plain": 0}
    assert cuda_cov.launches["plain"] > 0
