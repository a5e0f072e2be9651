"""Scan preprocessing: NaN masking + inverse crop box, and the masked median.

Counterpart of the JAX package's ``ops/preprocess.py`` (reference
``odom.cc:443-465``: ``removeNaNFromPointCloud`` then ``pcl::CropBox`` with
``setNegative(true)`` and box ``[-size, +size]^3``).
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE, PointCloud


def nan_crop_mask(
    points: torch.Tensor, mask: torch.Tensor, crop_size: float | None
) -> torch.Tensor:
    """Mask off non-finite points and points inside the sensor-centred crop box."""
    out = mask & torch.all(torch.isfinite(points), dim=-1)
    if crop_size is not None:
        inside = torch.all(torch.abs(points) <= crop_size, dim=-1)
        out = out & ~inside
    return out


def preprocess(cloud: PointCloud, crop_size: float | None) -> PointCloud:
    """NaN + crop-box masking, padding invalidated slots (compaction is left
    to the voxel filter, whose sort compacts for free)."""
    mask = nan_crop_mask(cloud.points, cloud.mask, crop_size)
    pts = torch.where(mask[..., None], cloud.points, PAD_VALUE)
    pts = torch.where(torch.isfinite(pts), pts, PAD_VALUE)
    return PointCloud(points=pts, mask=mask)


def ranges(points: torch.Tensor) -> torch.Tensor:
    """Euclidean range of each point from the sensor origin. [..., N, 3] -> [..., N]."""
    return torch.linalg.norm(points, dim=-1)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upper median over valid entries: the (count // 2)-th order statistic,
    as the reference's ``nth_element`` at n/2 (``odom.cc:990-1010``)."""
    vals = torch.where(mask, values, torch.inf)
    svals = torch.sort(vals, dim=-1).values
    n = torch.sum(mask.to(torch.int64), dim=-1)
    idx = torch.clamp(n // 2, 0, values.shape[-1] - 1)
    med = torch.gather(svals, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))
