"""Parity of the port's GICP (registration/gicp.py) with the JAX package's
pallas backend, from identical Morton-sorted scans and normals."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.io import synthetic
from direct_lidar_odometry_tpu.odometry import pipeline as jpipe
from direct_lidar_odometry_tpu.registration import gicp as jgicp
from direct_lidar_odometry_tpu_torch.registration import gicp as tgicp
from tests.test_pallas_e2e import SCAN_RANGE, pallas_cfg


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def scan_pair():
    """Two consecutive preprocessed scans with normals (computed once, by the
    JAX package, and handed to both packages as numpy)."""
    cfg = pallas_cfg()
    w = synthetic.make_world(np.random.default_rng(0), n_frames=10, extent=15.0, n_boxes=6,
                             speed=0.4, ground_points=3000, density=3.0)
    out = []
    for t in (0, 1):
        s = synthetic.render_scan(w, t, np.random.default_rng(50 + t),
                                  max_range=SCAN_RANGE, max_points=4096)
        pts = np.full((cfg.shapes.n_raw, 3), 1e6, np.float32)
        pts[: len(s)] = s
        mask = np.arange(cfg.shapes.n_raw) < len(s)
        scan = jpipe.preprocess_scan(jnp.asarray(pts), jnp.asarray(mask), cfg, "pallas")
        nrm = jpipe._scan_normals(scan, cfg, "pallas")
        out.append(tuple(np.asarray(a) for a in (scan.points, scan.mask, nrm.normals, nrm.valid)))
    gt = np.linalg.inv(w.poses[0]) @ w.poses[1]
    return cfg, out[0], out[1], gt.astype(np.float32)


@pytest.mark.parametrize("optimizer,max_corr", [("lm", 1.0), ("gn", 1.0), ("lm", 0.5)])
def test_align_matches_reference(scan_pair, optimizer, max_corr):
    """Transforms to 1e-4, iterations, flags and correspondence counts equal."""
    cfg, tgt, src, gt = scan_pair
    stage = dataclasses.replace(cfg.gicp.s2s, optimizer=optimizer,
                                max_correspondence_distance=max_corr)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = gt[:3, 3] * 0.5

    jt = jgicp.make_target(*map(jnp.asarray, tgt), max_corr, 4096, backend="pallas")
    js = jgicp.GicpSource(*map(jnp.asarray, src))
    rj = jgicp.align(js, jt, jnp.asarray(guess), stage, cap=8, backend="pallas")

    tt = tgicp.make_target(*map(_t, tgt))
    ts = tgicp.GicpSource(*map(_t, src))
    rt = tgicp.align(ts, tt, _t(guess), stage)

    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform), atol=1e-4)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    assert rt.lm_failed == bool(rj.lm_failed)
    assert int(rt.num_correspondences) == int(rj.num_correspondences) > 100
    np.testing.assert_allclose(float(rt.final_error), float(rj.final_error), rtol=1e-3)
    # and the registration is right: near the ground-truth relative pose
    np.testing.assert_allclose(rt.transform.numpy()[:3, 3], gt[:3, 3], atol=0.05)


def test_align_no_correspondences_stays_finite(scan_pair):
    """A guess 500 m away finds nothing: zero correspondences, finite output."""
    cfg, tgt, src, _ = scan_pair
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 500.0
    rt = tgicp.align(tgicp.GicpSource(*map(_t, src)), tgicp.make_target(*map(_t, tgt)),
                     _t(guess), cfg.gicp.s2m)
    assert int(rt.num_correspondences) == 0
    assert torch.isfinite(rt.transform).all()
