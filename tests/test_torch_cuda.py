"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` configures jax, which a machine
that runs only the port need not have.)

``chip_smoke.py`` runs the same comparisons at the full per-frame shapes.
"""

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn, morton

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_cloud(seed, n, dev, valid_frac=0.9, extent=12.0):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([
        rng.uniform(-extent, extent, n), rng.uniform(-extent, extent, n),
        rng.uniform(0.0, 2.5, n),
    ]).astype(np.float32)
    mask = rng.random(n) < valid_frac
    pts[~mask] = 1e6
    p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    order = morton.sort_order(p, m)
    return p[order].contiguous(), m[order].contiguous()


def _candidates(qp, qm, tp, tm, radius):
    qlo, qhi = morton.chunk_aabbs(qp, qm, cuda_nn.TILE)
    tlo, thi = morton.chunk_aabbs(tp, tm, morton.TARGET_CHUNK)
    return cuda_nn.candidate_chunks(qlo, qhi, tlo, thi, radius)


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5, 5.0])
def test_nn1_kernel_matches_plain(dev, radius):
    """Same distance formula and tie rule: idx and d2 bit-identical."""
    tp, tm = _sorted_cloud(0, 8192, dev)
    qp, qm = _sorted_cloud(1, 4096, dev)
    cand, counts = _candidates(qp, qm, tp, tm, radius)
    before = cuda_nn.launches["cuda"]
    ik, dk = cuda_nn.nn1_pruned(qp, qm, tp, tm, cand, counts, radius)
    ip, dp = cuda_nn.nn1_plain(qp, qm, tp, tm, radius)
    torch.cuda.synchronize()
    assert cuda_nn.launches["cuda"] == before + 1
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    assert (ik >= 0).sum() > 100


@pytest.mark.parametrize("radius", [0.75, 1.5])
def test_cov_kernel_matches_plain(dev, radius):
    """Neighbour counts exact; moments to summation-order rounding."""
    tp, tm = _sorted_cloud(2, 8192, dev, extent=8.0)
    cand, counts = _candidates(tp, tm, tp, tm, radius)
    mk = cuda_cov.cov_pruned(tp, tm, tp, tm, cand, counts, radius)
    mp = cuda_cov.cov_plain(tp, tm, tp, tm, radius)
    torch.cuda.synchronize()
    assert torch.equal(mk[:, 0], mp[:, 0])
    torch.testing.assert_close(mk, mp, atol=1e-3, rtol=1e-5)
    assert float(mp[tm, 0].mean()) > 4


def test_runner_on_cuda_uses_kernels(dev):
    from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu_torch.io import synthetic
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    cfg = DloConfig(nn_backend="pallas", shapes=ShapeConfig(
        n_raw=16384, n_scan=4096, n_keyframe=2048, max_keyframes=16, max_submap_kf=4,
        n_submap_flat=8192, hull_directions=16))
    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=6, speed=1.0, n_dynamic=0)
    beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
    runner = OdometryRunner(cfg, device="cuda")
    cuda_nn.reset_launches()
    cuda_cov.reset_launches()
    for t in range(6):
        scan = synthetic.render_raycast(world, t, rng, max_points=16384, beams=beams)
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
    assert cuda_nn.launches["cuda"] > 0 and cuda_nn.launches["plain"] == 0
    assert cuda_cov.launches["cuda"] > 0 and cuda_cov.launches["plain"] == 0
    assert np.isfinite(runner.trajectory()).all()

