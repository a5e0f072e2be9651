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
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn, morton as tmorton
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


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5])
def test_candidate_chunks_exact(clouds, radius):
    """Packed candidate words and counts are integer-identical."""
    tp, tm, qp, qm = clouds
    jq = jmorton.chunk_aabbs(jnp.asarray(qp), jnp.asarray(qm), 128)
    jt = jmorton.chunk_aabbs(jnp.asarray(tp), jnp.asarray(tm), 512)
    cand_j, cnt_j = pallas_nn.candidate_chunks(*jq, *jt, radius)
    tq = tmorton.chunk_aabbs(_t(qp), _t(qm), 128)
    tt = tmorton.chunk_aabbs(_t(tp), _t(tm), 512)
    cand_t, cnt_t = cuda_nn.candidate_chunks(*tq, *tt, radius)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    assert cnt_t.sum() > 0 and (cnt_t < tt[0].shape[1]).any()  # prunes something


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
    assert case == "candidate_table"  # K4 still takes the 128-query lists
    qlo, qhi = tmorton.chunk_aabbs(p[::2].contiguous(), m[::2].contiguous(), 128)
    cand, counts = cuda_nn.candidate_chunks(qlo, qhi, clo, chi, 1.0)
    return lambda: cuda_nn.nn1_pruned_mxu(p, m, p, m, cand, counts, 1.0), "candidate table"


@pytest.mark.parametrize("case", [
    "non_contiguous", "query_count", "chunk_aabb_shape", "chunk_aabb_dtype",
    "too_many_chunks", "visits_dtype", "visits_shape", "candidate_table",
])
def test_wrappers_reject_non_contiguous_and_bad_shapes(case):
    call, match = _bad_call(case)
    with pytest.raises(ValueError, match=match):
        call()


def test_search_entries_select_inside_the_kernel():
    """query_1nn_sorted and radius_moments_sorted build no candidate lists
    (K4's route still does); the CPU route's ``visits`` are the plain
    selection's candidate counts, and its results the plain versions'."""
    rng = np.random.default_rng(8)
    tp, tm = _sorted_cloud(rng, 2048)
    p, m = _t(tp), _t(tm)
    clo, chi = tmorton.chunk_aabbs(p, m, 512)
    cuda_nn.reset_launches()
    cuda_nn.query_1nn_sorted(p, m, clo, chi, p, m, 1.0)
    cuda_cov.radius_moments_sorted(p, m, clo, chi, p, m, 1.0)
    assert cuda_nn.candidate_calls == {"calls": 0}
    cuda_nn.query_1nn_sorted(p, m, clo, chi, p, m, 1.0, mxu=True)
    assert cuda_nn.candidate_calls == {"calls": 1}
    cuda_nn.reset_launches()
    assert cuda_nn.candidate_calls == {"calls": 0}

    want = cuda_nn.subtile_candidates(p, m, clo, chi, 1.0).sum(dim=1, dtype=torch.int32)
    v_nn = torch.full((2048 // 32,), -1, dtype=torch.int32)
    v_cov = torch.full((2048 // 32,), -1, dtype=torch.int32)
    idx, d2 = cuda_nn.nn1_pruned(p, m, p, m, clo, chi, 1.0, v_nn)
    mom = cuda_cov.cov_pruned(p, m, p, m, clo, chi, 1.0, v_cov)
    assert torch.equal(v_nn, want) and torch.equal(v_cov, want)
    assert 0 < int(want.sum()) < want.numel() * 4  # selects, and prunes
    i_p, d_p = cuda_nn.nn1_plain(p, m, p, m, 1.0)
    assert torch.equal(idx, i_p) and torch.equal(d2, d_p)
    assert torch.equal(mom, cuda_cov.cov_plain(p, m, p, m, 1.0))


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
    """The selection math the K1/K2 kernels mirror: for sub-tiles of 16-128
    queries, every valid target within r of a valid query (d2 rounded as the
    kernels round it, inclusive) lies in a chunk on that query's sub-tile's
    candidate list; sub-tiles without a valid query and empty chunks give
    +inf gaps, no candidate and no NaN."""
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
