"""Parity of the port's kernel modules (ops/cuda_nn.py, ops/cuda_cov.py and
the normals on top of them) with the JAX package's Pallas path.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do. The kernels themselves run only on a card: see
``tests/test_torch_cuda.py``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from direct_lidar_odometry_tpu.ops import morton as jmorton, pallas_cov, pallas_nn
from direct_lidar_odometry_tpu.registration import covariance as jcov
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn, morton as tmorton
from direct_lidar_odometry_tpu_torch.registration import covariance as tcov


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _sorted_cloud(rng, n, valid_frac=0.9, extent=12.0):
    """Morton-sorted cloud (sorted by the JAX package, so both sides see the
    same order), as numpy."""
    pts = np.column_stack([
        rng.uniform(-extent, extent, n),
        rng.uniform(-extent, extent, n),
        rng.uniform(0.0, 2.5, n),
    ]).astype(np.float32)
    mask = rng.random(n) < valid_frac
    pts[~mask] = 1e6
    order = np.asarray(jmorton.sort_order(jnp.asarray(pts), jnp.asarray(mask)))
    return pts[order], mask[order]


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    tp, tm = _sorted_cloud(rng, 4096)
    qp, qm = _sorted_cloud(rng, 2048)
    return tp, tm, qp, qm


@pytest.mark.parametrize("radius", [0.5, 0.8, 1.5])
def test_query_1nn_sorted_matches_reference(clouds, radius):
    """found and d2 exact; idx equal except among near-ties (2^-14 relative)."""
    tp, tm, qp, qm = clouds
    clo, chi = jmorton.chunk_aabbs(jnp.asarray(tp), jnp.asarray(tm), 512)
    i_j, d_j, f_j = map(np.asarray, pallas_nn.query_1nn_sorted(
        jnp.asarray(tp), jnp.asarray(tm), clo, chi, jnp.asarray(qp), jnp.asarray(qm), radius))
    tclo, tchi = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    i_t, d_t, f_t = (x.numpy() for x in cuda_nn.query_1nn_sorted(
        _t(tp), _t(tm), tclo, tchi, _t(qp), _t(qm), radius))
    assert (f_t == f_j).all()
    assert f_t.sum() > 100
    np.testing.assert_allclose(d_t[f_t], d_j[f_t], rtol=1e-6)
    same = i_t[f_t] == i_j[f_t]
    tie = np.abs(d_t[f_t] - d_j[f_t]) <= 2.0**-14 * d_j[f_t]
    assert (same | tie).all()
    assert (i_t[~f_t] == -1).all()
    assert tm[i_t[f_t]].all()  # masked targets never returned


def test_query_1nn_sorted_empty_target():
    rng = np.random.default_rng(2)
    qp, qm = _sorted_cloud(rng, 512)
    tp = torch.full((1024, 3), 1e6)
    tm = torch.zeros(1024, dtype=torch.bool)
    clo, chi = tmorton.chunk_aabbs(tp, tm, 512)
    idx, d2, found = cuda_nn.query_1nn_sorted(tp, tm, clo, chi, _t(qp), _t(qm), 1.0)
    assert not found.any() and (idx == -1).all() and torch.isinf(d2).all()


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_radius_moments_sorted_matches_reference(radius):
    """Counts exact; moments to 1e-4 absolute (summation order differs), for
    every valid query (JAX leaves invalid queries' rows unspecified)."""
    rng = np.random.default_rng(3)
    tp, tm = _sorted_cloud(rng, 2048, extent=6.0)
    clo, chi = jmorton.chunk_aabbs(jnp.asarray(tp), jnp.asarray(tm), 512)
    m_j = np.asarray(pallas_cov.radius_moments_sorted(
        jnp.asarray(tp), jnp.asarray(tm), clo, chi, jnp.asarray(tp), jnp.asarray(tm), radius))
    tclo, tchi = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    m_t = cuda_cov.radius_moments_sorted(
        _t(tp), _t(tm), tclo, tchi, _t(tp), _t(tm), radius).numpy()
    np.testing.assert_array_equal(m_t[tm, 0], m_j[tm, 0])
    np.testing.assert_allclose(m_t[tm], m_j[tm], atol=1e-4)
    assert (m_t[~tm] == 0).all()
    assert m_t[tm, 0].mean() > 4


def test_moments_to_cov_matches_reference():
    m = np.random.default_rng(4).normal(size=(256, 10)).astype(np.float32)
    m[:, 0] = np.abs(m[:, 0]) * 10
    cj, nj = pallas_cov.moments_to_cov(jnp.asarray(m))
    ct, nt = cuda_cov.moments_to_cov(_t(m))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_normals_match_reference(radius):
    """Validity exact; |n . n'| >= 1 - 1e-4 where both are valid."""
    rng = np.random.default_rng(5)
    tp, tm = _sorted_cloud(rng, 2048, extent=5.0)
    clo, chi = jmorton.chunk_aabbs(jnp.asarray(tp), jnp.asarray(tm), 512)
    nj = jcov.estimate_normals_radius_sorted(jnp.asarray(tp), jnp.asarray(tm), clo, chi, radius)
    tclo, tchi = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    nt = tcov.estimate_normals_radius_sorted(_t(tp), _t(tm), tclo, tchi, radius)
    vj, vt = np.asarray(nj.valid), nt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 100
    # well-conditioned neighbourhoods only: a near-isotropic neighbourhood's
    # smallest eigenvector is not determined by the data
    m = cuda_cov.radius_moments_sorted(_t(tp), _t(tm), tclo, tchi, _t(tp), _t(tm), radius)
    ev = np.linalg.eigvalsh(cuda_cov.moments_to_cov(m)[0].numpy().astype(np.float64))
    sep = (ev[:, 1] - ev[:, 0]) > 1e-3 * np.maximum(ev[:, 2], 1e-12)
    both = vt & vj & sep
    dots = np.abs(np.sum(nt.normals.numpy() * np.asarray(nj.normals), axis=-1))
    assert dots[both].min() >= 1 - 1e-4


def test_wrappers_route_cpu_to_plain_and_count():
    rng = np.random.default_rng(6)
    tp, tm = _sorted_cloud(rng, 1024)
    clo, chi = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    cuda_nn.reset_launches()
    cuda_cov.reset_launches()
    cuda_nn.query_1nn_sorted(_t(tp), _t(tm), clo, chi, _t(tp), _t(tm), 1.0)
    cuda_cov.radius_moments_sorted(_t(tp), _t(tm), clo, chi, _t(tp), _t(tm), 1.0)
    assert cuda_nn.launches == {"cuda": 0, "plain": 1}
    assert cuda_cov.launches == {"cuda": 0, "plain": 1}


def _bad_call(case):
    """One call of a kernel wrapper with one wrong input, and the error it
    must raise."""
    rng = np.random.default_rng(7)
    tp, tm = _sorted_cloud(rng, 2048)
    p, m = _t(tp), _t(tm)
    clo, chi = tmorton.chunk_aabbs(p, m, 512)
    if case == "non_contiguous":
        return lambda: cuda_nn.nn1_pruned(p[::2], m[::2], p, m, clo, chi, 1.0), "contiguous"
    if case == "query_count":
        return lambda: cuda_cov.cov_pruned(p, m, p[:100], m[:100], clo, chi, 1.0), "need Q"
    if case == "chunk_aabb_shape":
        lo2, hi2 = clo[:, :2].contiguous(), chi[:, :2].contiguous()
        return lambda: cuda_nn.nn1_pruned(p, m, p, m, lo2, hi2, 1.0), "chunk AABBs"
    if case == "chunk_aabb_dtype":
        return lambda: cuda_cov.cov_pruned(p, m, p, m, clo.double(), chi, 1.0), "chunk_lo must be"
    if case == "too_many_chunks":
        big = torch.zeros((512 * 1025, 3))
        bm = torch.zeros(512 * 1025, dtype=torch.bool)
        blo, bhi = tmorton.chunk_aabbs(big, bm, 512)
        return lambda: cuda_nn.nn1_pruned(p, m, big, bm, blo, bhi, 1.0), "exceed"
    if case == "visits_dtype":
        v = torch.zeros(2048 // 32, dtype=torch.int64)
        return lambda: cuda_nn.nn1_pruned(p, m, p, m, clo, chi, 1.0, v), "visits must be"
    if case == "visits_shape":
        v = torch.zeros(2048 // 128, dtype=torch.int32)
        return lambda: cuda_cov.cov_pruned(p, m, p, m, clo, chi, 1.0, v), "visits"
    if case == "k4_visits_shape":
        v = torch.zeros(2048 // 128, dtype=torch.int32)
        return lambda: cuda_nn.nn1_pruned_mxu(p, m, p, m, clo, chi, 1.0, v), "visits"
    assert case == "k3_chunk_aabb_shape"  # K3 reports its visits in hb slot 29
    lo2, hi2 = clo[:, :2].contiguous(), chi[:, :2].contiguous()
    seed = torch.full((2048,), -1, dtype=torch.int32)
    return (lambda: cuda_gicp.fused_linearize_pruned(p, p, m, seed, p, m, p, m, lo2, hi2, 1.0,
                                                     1e-3), "chunk AABBs")


@pytest.mark.parametrize("case", [
    "non_contiguous", "query_count", "chunk_aabb_shape", "chunk_aabb_dtype",
    "too_many_chunks", "visits_dtype", "visits_shape", "k4_visits_shape", "k3_chunk_aabb_shape",
])
def test_wrappers_reject_non_contiguous_and_bad_shapes(case):
    call, match = _bad_call(case)
    with pytest.raises(ValueError, match=match):
        call()


def test_search_entries_select_inside_the_kernel():
    """Every pruned search takes the chunk AABBs and builds no candidate
    lists (the port has no list builder); the CPU route's ``visits`` are
    the plain selection's candidate counts, and its results the plain
    versions'."""
    assert not hasattr(cuda_nn, "candidate_chunks")
    rng = np.random.default_rng(8)
    tp, tm = _sorted_cloud(rng, 2048)
    p, m = _t(tp), _t(tm)
    clo, chi = tmorton.chunk_aabbs(p, m, 512)
    want = cuda_nn.subtile_candidates(p, m, clo, chi, 1.0).sum(dim=1, dtype=torch.int32)
    v_nn = torch.full((2048 // 32,), -1, dtype=torch.int32)
    v_cov = torch.full((2048 // 32,), -1, dtype=torch.int32)
    v_mxu = torch.full((2048 // 32,), -1, dtype=torch.int32)
    idx, d2 = cuda_nn.nn1_pruned(p, m, p, m, clo, chi, 1.0, v_nn)
    mom = cuda_cov.cov_pruned(p, m, p, m, clo, chi, 1.0, v_cov)
    i_x, d_x = cuda_nn.nn1_pruned_mxu(p, m, p, m, clo, chi, 1.0, v_mxu)
    assert torch.equal(v_nn, want) and torch.equal(v_cov, want)
    assert 0 < int(want.sum()) < want.numel() * 4  # selects, and prunes
    want_x = cuda_nn.expansion_candidates(p, m, clo, chi, 1.0).sum(dim=1, dtype=torch.int32)
    assert torch.equal(v_mxu, want_x) and bool((want_x >= want).all())
    i_p, d_p = cuda_nn.nn1_plain(p, m, p, m, 1.0)
    assert torch.equal(idx, i_p) and torch.equal(d2, d_p)
    assert torch.equal(mom, cuda_cov.cov_plain(p, m, p, m, 1.0))
    i_xp, d_xp = cuda_nn.nn1_mxu_plain(p, m, p, m, 1.0)
    assert torch.equal(i_x, i_xp) and torch.equal(d_x, d_xp)


def _expansion_d2(qp, tp):
    """[Q, T] K4 distances in the kernel's order: max((|q|^2 + |t|^2) - 2 q.t, 0)."""
    q2 = (qp[:, 0] * qp[:, 0] + qp[:, 1] * qp[:, 1]) + qp[:, 2] * qp[:, 2]
    t2 = (tp[:, 0] * tp[:, 0] + tp[:, 1] * tp[:, 1]) + tp[:, 2] * tp[:, 2]
    g = (qp[:, None, 0] * tp[None, :, 0] + qp[:, None, 1] * tp[None, :, 1]) \
        + qp[:, None, 2] * tp[None, :, 2]
    return torch.clamp((q2[:, None] + t2[None, :]) - 2.0 * g, min=0.0)


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5])
def test_k4_visits_cover_every_expansion_hit(radius):
    """K4's CPU route at map-scale coordinates (the clouds ~40 m from the
    origin, where the expansion reads pairs up to ~1e-4 m^2 off): ``visits``
    are :func:`expansion_candidates`' counts, a superset of the exact
    selection; every pair whose expansion d2 is < r^2 lies in a candidate
    chunk, so the kernel sees every target its plain version can pick; idx
    and d2 are the plain version's."""
    rng = np.random.default_rng(20)
    shift = np.array([30.0, -25.0, 1.0], np.float32)
    tp, tm = _sorted_cloud(rng, 4096)
    qp, qm = _sorted_cloud(rng, 2048)
    tp, qp = _t(np.where(tm[:, None], tp + shift, tp)), _t(np.where(qm[:, None], qp + shift, qp))
    tm, qm = _t(tm), _t(qm)
    clo, chi = tmorton.chunk_aabbs(tp, tm, 512)
    visits = torch.full((2048 // 32,), -1, dtype=torch.int32)
    idx, d2 = cuda_nn.nn1_pruned_mxu(qp, qm, tp, tm, clo, chi, radius, visits)
    cand = cuda_nn.expansion_candidates(qp, qm, clo, chi, radius)
    exact = cuda_nn.subtile_candidates(qp, qm, clo, chi, radius)
    assert torch.equal(visits, cand.sum(dim=1, dtype=torch.int32))
    assert bool((cand | ~exact).all()) and 0 < int(visits.sum()) < cand.numel()
    hit = (_expansion_d2(qp, tp) < cuda_nn.f32_radius2(radius)) & qm[:, None] & tm[None, :]
    qi, ti = torch.nonzero(hit, as_tuple=True)
    assert qi.numel() > 100 and bool(cand[qi // 32, ti // 512].all())
    i_p, d_p = cuda_nn.nn1_mxu_plain(qp, qm, tp, tm, radius)
    assert torch.equal(idx, i_p) and torch.equal(d2, d_p)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    sub=st.sampled_from([16, 32, 64, 128]),
    chunk=st.sampled_from([16, 64, 128]),
    radius=st.floats(0.05, 3.0),
    extent=st.floats(0.5, 30.0),
    valid_frac=st.floats(0.0, 1.0),
    dead_tile=st.booleans(),
    dead_chunk=st.booleans(),
)
def test_subtile_selection_covers_every_neighbour(
    seed, sub, chunk, radius, extent, valid_frac, dead_tile, dead_chunk,
):
    """The selection math the K1-K4 kernels mirror: for sub-tiles of 16-128
    queries, every valid target within r of a valid query (d2 rounded as the
    kernels round it, inclusive) lies in a chunk on that query's sub-tile's
    candidate list, and so does every pair K4's expansion puts below r^2;
    sub-tiles without a valid query and empty chunks give +inf gaps, no
    candidate and no NaN."""
    rng = np.random.default_rng(seed)
    n_q, n_t = 256, 512

    def cloud(n, frac):
        pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        mask = rng.random(n) < frac
        pts[~mask] = 1e6
        return _t(pts), _t(mask)

    qp, qm = tmorton.sort_cloud(*cloud(n_q, valid_frac))
    tp, tm = cloud(n_t, max(valid_frac, 0.5))
    # a few targets at (about) r from a query, where rounding decides
    near = rng.integers(0, n_q, 16)
    tp[:16] = qp[near] + torch.tensor([radius, 0.0, 0.0])
    tm[:16] = qm[near]
    tp, tm = tmorton.sort_cloud(tp, tm)
    qm, tm = qm.clone(), tm.clone()
    if dead_tile:
        qm[sub:2 * sub] = False
    if dead_chunk:
        tm[chunk:2 * chunk] = False

    clo, chi = tmorton.chunk_aabbs(tp, tm, chunk)
    gap2 = cuda_nn.subtile_gap2(qp, qm, clo, chi, sub)
    cand = cuda_nn.subtile_candidates(qp, qm, clo, chi, radius, sub)
    assert gap2.shape == (n_q // sub, n_t // chunk) and not torch.isnan(gap2).any()
    d = qp[:, None, :] - tp[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    within = (d2 <= cuda_nn.f32_radius2(radius)) & qm[:, None] & tm[None, :]
    qi, ti = torch.nonzero(within, as_tuple=True)
    assert cand[qi // sub, ti // chunk].all()
    dead_q = ~qm.reshape(-1, sub).any(dim=1)
    dead_c = ~tm.reshape(-1, chunk).any(dim=1)
    assert torch.isinf(gap2[dead_q]).all() and torch.isinf(gap2[:, dead_c]).all()
    assert not cand[dead_q].any() and not cand[:, dead_c].any()
    # K4's selection: every pair whose expansion d2 is < r^2, no dead row
    cand_x = cuda_nn.expansion_candidates(qp, qm, clo, chi, radius, sub)
    hit = (_expansion_d2(qp, tp) < cuda_nn.f32_radius2(radius)) & qm[:, None] & tm[None, :]
    qi, ti = torch.nonzero(hit, as_tuple=True)
    assert cand_x[qi // sub, ti // chunk].all() and bool((cand_x | ~cand).all())
    assert not cand_x[dead_q].any() and not cand_x[:, dead_c].any()
    # the gaps of live pairs are the float64 box gaps up to f32 rounding
    def boxes(p, m, n):
        p = np.where(m.numpy()[:, None], p.numpy().astype(np.float64), np.nan).reshape(-1, n, 3)
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN boxes of dead rows
            return np.nanmin(p, axis=1), np.nanmax(p, axis=1)
    (qlo, qhi), (clo64, chi64) = boxes(qp, qm, sub), boxes(tp, tm, chunk)
    g = np.maximum(np.maximum(clo64[None] - qhi[:, None], qlo[:, None] - chi64[None]), 0.0)
    live = ~dead_q.numpy()[:, None] & ~dead_c.numpy()[None, :]
    np.testing.assert_allclose(gap2.numpy()[live], np.sum(g * g, axis=-1)[live],
                               rtol=1e-5, atol=1e-5)
