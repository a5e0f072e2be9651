"""Per-point surface normals for PLANE-regularized GICP covariances.

Counterpart of the JAX package's ``registration/covariance.py`` (reference
``nano_gicp_impl.hpp:298-357``). Under PLANE regularization the covariance
depends only on the neighbourhood's smallest eigenvector n:

    C_reg = R diag(1, 1, eps) R^T = I - (1 - eps) n n^T

so only normals are stored; covariances are rebuilt where the Mahalanobis
weights need them. Neighbourhoods are all points within a fixed radius
(``ops/cuda_cov.py``: kernel K1 over a Morton-sorted cloud, the exhaustive
kernel K6 over any cloud).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_cov, eigh3

PLANE_EPS = 1e-3  # reference nano_gicp_impl.hpp:339: values = (1, 1, 1e-3)


class Normals(NamedTuple):
    normals: torch.Tensor  # [N, 3] unit normals (arbitrary sign)
    valid: torch.Tensor    # [N] bool — enough neighbors to estimate


def _normals_from_moments(m: torch.Tensor, mask: torch.Tensor, min_neighbors: int) -> Normals:
    cov, count = cuda_cov.moments_to_cov(m)
    normal, _ = eigh3.smallest_eigvec3(cov)
    valid = mask & (count >= min_neighbors)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype, device=normal.device)
    normal = torch.where(valid[..., None], normal, z)
    return Normals(normals=normal, valid=valid)


def estimate_normals_radius(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    min_neighbors: int = 4,
) -> Normals:
    """Normals from ALL neighbours within ``radius``, any point order, via
    the exhaustive moment kernel K6 (``min_neighbors`` counts the point
    itself)."""
    m = cuda_cov.radius_moments(points, mask, points, radius)
    return _normals_from_moments(m, mask, min_neighbors)


def estimate_normals_radius_sorted(
    points: torch.Tensor,
    mask: torch.Tensor,
    chunk_lo: torch.Tensor,
    chunk_hi: torch.Tensor,
    radius: float,
    min_neighbors: int = 4,
) -> Normals:
    """:func:`estimate_normals_radius` over a Morton-sorted cloud, through
    the pruned moment kernel K1."""
    m = cuda_cov.radius_moments_sorted(
        points, mask, chunk_lo, chunk_hi, points, mask, radius
    )
    return _normals_from_moments(m, mask, min_neighbors)


def cov_from_normal(n: torch.Tensor, eps: float = PLANE_EPS) -> torch.Tensor:
    """PLANE-regularized covariance I - (1-eps) n n^T. [..., 3] -> [..., 3, 3]."""
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    outer = n[..., :, None] * n[..., None, :]
    return eye - (1.0 - eps) * outer
