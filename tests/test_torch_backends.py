"""The port's "brute" and "hashgrid" searches (``ops/bruteforce.py``,
``ops/hashgrid.py``) and the k-NN normals (``registration/covariance.py``)
against the JAX package on the same seeded clouds.

1-NN indices may differ from the reference only at near-ties (two d2
within 2^-14 relative, ROADMAP Queue 3); d2 agree within 1e-6 relative
(XLA fuses the reference's three squares into one reduction whose rounding
order is its own). ``hashgrid.build`` is bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.ops import bruteforce as jbf, hashgrid as jhg
from direct_lidar_odometry_tpu.registration import covariance as jcov
from direct_lidar_odometry_tpu_torch.ops import bruteforce as tbf, hashgrid as thg
from direct_lidar_odometry_tpu_torch.registration import covariance as tcov

NEAR_TIE = 2.0**-14


def _cloud(seed, n=4096, extent=20.0, invalid=0.2):
    """Points on three planes plus scatter, some invalid (at the pad value)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    third = n // 3
    pts[:third, 2] = 0.0
    pts[third:2 * third, 0] = 5.0
    pts += rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    mask = rng.uniform(size=n) > invalid
    pts[~mask] = 1e6
    return pts, mask


def _queries(pts, mask, seed, n=2048, noise=0.3):
    rng = np.random.default_rng(seed)
    q = (pts[:n] + rng.normal(scale=noise, size=(n, 3))).astype(np.float32)
    return q, mask[:n] | (rng.uniform(size=n) > 0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_1nn(jres, tres, q, targets):
    """found equal; idx equal except near-ties; d2 within 1e-6 relative."""
    ji, jd, jf = (np.asarray(a) for a in jres)
    ti, td, tf = (a.numpy() for a in tres)
    assert ti.dtype == ji.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(td[jf], jd[jf], rtol=1e-6)
    diff = np.nonzero(ti != ji)[0]
    for i in diff:
        a = np.sum((q[i] - targets[ti[i]]) ** 2)
        b = np.sum((q[i] - targets[ji[i]]) ** 2)
        assert abs(a - b) <= NEAR_TIE * max(a, b), (i, a, b)
    assert int(jf.sum()) > 500
    return len(diff)


def _check_knn(jres, tres, q, targets, share=0.01):
    """valid equal; neighbours equal except near-ties (where two neighbours'
    d2 agree within 2^-14 relative, the reference's fused rounding may
    order them the other way), at most ``share`` of the valid neighbours;
    d2 within 1e-6 relative."""
    jidx, jd2, jv = (np.asarray(a) for a in jres)
    tidx, td2, tv = (a.numpy() for a in tres)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td2[jv], jd2[jv], rtol=1e-6)
    rows, cols = np.nonzero(tidx != jidx)
    q64, t64 = q.astype(np.float64), targets.astype(np.float64)
    a = np.sum((q64[rows] - t64[tidx[rows, cols]]) ** 2, axis=-1)
    b = np.sum((q64[rows] - t64[jidx[rows, cols]]) ** 2, axis=-1)
    assert np.all(np.abs(a - b) <= NEAR_TIE * np.maximum(a, b)), np.abs(a - b).max()
    assert len(rows) <= share * jv.sum()
    assert jv.sum() > 1000


@pytest.mark.parametrize("radius,tile", [(0.5, 1024), (1.5, 4096)])
def test_bruteforce_query_1nn_matches_reference(radius, tile, monkeypatch):
    """Tiled over the targets (the JAX tile) and over the queries (a small
    MAX_ELEMS here forces several query tiles)."""
    pts, mask = _cloud(0)
    q, qm = _queries(pts, mask, 1)
    jres = jbf.query_1nn(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qm),
                         radius, tile=tile)
    monkeypatch.setattr(tbf, "MAX_ELEMS", 300 * tile)
    tres = tbf.query_1nn(_t(pts), _t(mask), _t(q), _t(qm), radius, tile=tile)
    _check_1nn(jres, tres, q, pts)


def test_bruteforce_query_knn_matches_reference(monkeypatch):
    """Exact k-NN: the same neighbours in the same order (exact ties in
    target order, as ``lax.top_k``) but for near-ties, with the query rows
    cut below the JAX chunk."""
    pts, mask = _cloud(2, n=2048)
    q, qm = _queries(pts, mask, 3, n=2048, noise=0.05)
    jres = jbf.query_knn(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qm), 10,
                         chunk=1024)
    monkeypatch.setattr(tbf, "MAX_ELEMS", 300 * 2048)
    _check_knn(jres, tbf.query_knn(_t(pts), _t(mask), _t(q), _t(qm), 10, chunk=1024), q, pts)


@pytest.mark.parametrize("cell,table", [(0.5, 2**12), (1.0, 2**10), (3.0, 2**14)])
def test_hashgrid_build_bitwise_equal_reference(cell, table):
    """points, src_index, mask, key2, start, count and cell_size: the same
    dtypes and the same bits."""
    pts, mask = _cloud(4)
    jg = jhg.build(jnp.asarray(pts), jnp.asarray(mask), cell, table)
    tg = thg.build(_t(pts), _t(mask), cell, table)
    for f in jhg.HashGrid._fields:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("cap", [16, 2])
def test_hashgrid_query_1nn_matches_reference(cap):
    """cap 2 truncates most cells of this cloud (lowest sorted index wins
    in both)."""
    pts, mask = _cloud(5)
    q, qm = _queries(pts, mask, 6)
    jg = jhg.build(jnp.asarray(pts), jnp.asarray(mask), 1.0, 2**12)
    tg = thg.build(_t(pts), _t(mask), 1.0, 2**12)
    counts = tg.count.numpy()
    assert cap > counts.max() or (counts > cap).sum() > 100
    jres = jhg.query_1nn(jg, jnp.asarray(q), jnp.asarray(qm), 1.0, cap)
    tres = thg.query_1nn(tg, _t(q), _t(qm), 1.0, cap)
    _check_1nn(jres, tres, q, pts)


@pytest.mark.parametrize("cap", [48, 4])
def test_hashgrid_query_knn_matches_reference(cap):
    """The same neighbours in the same order (exact ties in candidate
    order) but for near-ties, with and without cap truncation."""
    pts, mask = _cloud(7, extent=8.0)
    q, qm = _queries(pts, mask, 8, noise=0.05)
    jg = jhg.build(jnp.asarray(pts), jnp.asarray(mask), 1.0, 2**12)
    tg = thg.build(_t(pts), _t(mask), 1.0, 2**12)
    assert (tg.count.numpy() > 4).sum() > 100  # cap 4 truncates
    jres = jhg.query_knn(jg, jnp.asarray(q), jnp.asarray(qm), 10, cap, chunk=1024)
    _check_knn(jres, thg.query_knn(tg, _t(q), _t(qm), 10, cap, chunk=1024), q, pts)


@pytest.mark.parametrize("kind", ["brute", "twoscale"])
def test_knn_normals_match_reference(kind):
    """``estimate_normals_brute`` / ``estimate_normals_twoscale``: valid masks
    equal, normals within 1e-4 up to sign."""
    pts, mask = _cloud(9, n=2048, extent=6.0)
    if kind == "brute":
        jn = jcov.estimate_normals_brute(jnp.asarray(pts), jnp.asarray(mask), k=10, chunk=1024)
        tn = tcov.estimate_normals_brute(_t(pts), _t(mask), k=10, chunk=1024)
    else:
        fn = jax.jit(lambda p, m: jcov.estimate_normals_twoscale(p, m, k=10, cap=32, chunk=1024,
                                                                 table_size=2**12))
        jn = fn(jnp.asarray(pts), jnp.asarray(mask))
        tn = tcov.estimate_normals_twoscale(_t(pts), _t(mask), k=10, cap=32, chunk=1024,
                                            table_size=2**12)
    jv, tv = np.asarray(jn.valid), tn.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 1000
    dots = np.abs(np.sum(np.asarray(jn.normals)[jv] * tn.normals.numpy()[jv], axis=-1))
    assert np.all(dots >= 1.0 - 1e-4) and np.all(dots <= 1.0 + 1e-4), dots.min()
