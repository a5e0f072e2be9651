"""Per-point surface normals for PLANE-regularized GICP covariances.

Counterpart of the JAX package's ``registration/covariance.py`` (reference
``nano_gicp_impl.hpp:298-357``). Under PLANE regularization the covariance
depends only on the neighbourhood's smallest eigenvector n:

    C_reg = R diag(1, 1, eps) R^T = I - (1 - eps) n n^T

so only normals are stored; covariances are rebuilt where the Mahalanobis
weights need them. On the pruned-kernel backends a neighbourhood is every
point within a fixed radius (``ops/cuda_cov.py``: kernel K1 over a
Morton-sorted cloud, the exhaustive kernel K6 over any cloud); the
``"brute"`` backend takes the exact k nearest (``ops/bruteforce.py``) and
``"hashgrid"`` the k nearest within a fine and a coarse hash grid
(``ops/hashgrid.py``).

The reference divides by k even when fewer neighbours are returned
(``nano_gicp_impl.hpp:319``); normals are scale-invariant, so the masked
k-NN statistics here divide by the true count, as in the JAX package.

The k-NN estimates also take B lanes (clouds [B, N, 3], the batched step):
the searches and the grids are lane-generic; each lane's neighbourhood
sums run in the single-cloud operations (``utils/lanes.per_lane``), since
on the card a reduction or a batched product over [B, N, ...] may add in
another order than over [N, ...].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.ops import bruteforce, cuda_cov, eigh3, hashgrid
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane

PLANE_EPS = 1e-3  # reference nano_gicp_impl.hpp:339: values = (1, 1, 1e-3)


class Normals(NamedTuple):
    normals: torch.Tensor  # [N, 3] unit normals (arbitrary sign)
    valid: torch.Tensor    # [N] bool — enough neighbors to estimate


def _masked_normals(normal: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype, device=normal.device)
    return torch.where(valid[..., None], normal, z)


def _knn_cov(neigh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Covariance [N, 3, 3] of each point's weighted neighbours ([N, k, 3],
    weights [N, k, 1])."""
    cnt = torch.clamp(torch.sum(w, dim=-2), min=1.0)    # [N, 1]
    mean = torch.sum(neigh * w, dim=-2) / cnt
    centered = (neigh - mean[..., None, :]) * w
    return torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]


def _normals_from_knn(points, kidx, kvalid, mask, min_neighbors):
    """Normal per point from its k-NN rows (indices into ``points``):
    (normals, valid, neighbours found); of each lane for [B, N, 3] points
    and [B, N, k] rows."""
    j = torch.clamp(kidx, min=0)
    w = kvalid.to(torch.float32)[..., None]             # [N, k, 1]
    if kidx.dim() == 3:
        lane = torch.arange(points.shape[0], device=points.device)[:, None, None]
        cov = per_lane(_knn_cov, points[lane, j], w)
    else:
        cov = _knn_cov(points[j], w)                    # neighbours [N, k, 3]
    normal, _ = eigh3.smallest_eigvec3(cov)
    found = torch.sum(kvalid, dim=-1)
    valid = mask & (found >= min_neighbors)
    return _masked_normals(normal, valid), valid, found


def estimate_normals(
    grid: hashgrid.HashGrid,
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    cap: int,
    chunk: int = 4096,
    min_neighbors: int = 3,
    far_grid: hashgrid.HashGrid | None = None,
    far_cap: int = 32,
) -> Normals:
    """Surface normal per point from its k-NN within the hash grid's cells.

    The reference's kd-tree kNN is unbounded (``nano_gicp_impl.hpp:313``);
    a hash-grid window is not, so with ``far_grid`` (cells several times
    larger) points whose fine window holds fewer than k neighbours take the
    coarse result instead (the two-scale search of the JAX package).
    """
    kidx, _, kvalid = hashgrid.query_knn(grid, points, mask, k=k, cap=cap, chunk=chunk)
    normal, valid, found = _normals_from_knn(points, kidx, kvalid, mask, min_neighbors)
    if far_grid is not None:
        kidx2, _, kvalid2 = hashgrid.query_knn(far_grid, points, mask, k=k, cap=far_cap,
                                               chunk=chunk)
        normal2, valid2, _ = _normals_from_knn(points, kidx2, kvalid2, mask, min_neighbors)
        use_far = found < k
        normal = torch.where(use_far[..., None], normal2, normal)
        valid = torch.where(use_far, valid2, valid)
    return Normals(normals=normal, valid=valid)


def estimate_normals_brute(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    chunk: int = 2048,
    min_neighbors: int = 3,
) -> Normals:
    """Normals from the exact unbounded k-NN (the reference's kd-tree
    semantics, ``nano_gicp_impl.hpp:313``) by exhaustive search."""
    kidx, _, kvalid = bruteforce.query_knn(points, mask, points, mask, k=k, chunk=chunk)
    normal, valid, _ = _normals_from_knn(points, kidx, kvalid, mask, min_neighbors)
    return Normals(normals=normal, valid=valid)


def estimate_normals_twoscale(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    cell: float = 1.0,
    far_cell: float = 3.0,
    table_size: int = 2 ** 14,
    cap: int = 64,
    far_cap: int = 32,
    chunk: int = 4096,
) -> Normals:
    """Build a fine and a coarse grid over the cloud and estimate (see
    :func:`estimate_normals`)."""
    grid = hashgrid.build(points, mask, cell, table_size)
    far_grid = hashgrid.build(points, mask, far_cell, table_size)
    return estimate_normals(grid, points, mask, k=k, cap=cap, chunk=chunk,
                            far_grid=far_grid, far_cap=far_cap)


def _normals_from_moments(m: torch.Tensor, mask: torch.Tensor, min_neighbors: int) -> Normals:
    cov, count = cuda_cov.moments_to_cov(m)
    normal, _ = eigh3.smallest_eigvec3(cov)
    valid = mask & (count >= min_neighbors)
    return Normals(normals=_masked_normals(normal, valid), valid=valid)


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
