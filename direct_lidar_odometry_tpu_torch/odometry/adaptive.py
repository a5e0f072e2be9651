"""Adaptive keyframe threshold from the spaciousness metric.

Counterpart of the JAX package's ``odometry/adaptive.py``: reference
``computeSpaciousness`` (``odom.cc:990-1010``, low-pass filtered median
point range) and ``setAdaptiveParams`` (``odom.cc:1188-1204``).
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.ops import preprocess


def update_spaciousness(
    prev: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, alpha: float = 0.95,
    max_samples: int = 4096,
) -> torch.Tensor:
    """s_t = alpha * s_{t-1} + (1-alpha) * median(range); prev < 0 = unseeded.

    The median is taken over an even-stride subsample of at most
    ``max_samples`` points of the Morton-ordered cloud (spatially uniform).
    """
    n = points.shape[-2]
    if n > max_samples:
        stride = (n + max_samples - 1) // max_samples
        points = points[..., ::stride, :]
        mask = mask[..., ::stride]
    med = preprocess.masked_median(preprocess.ranges(points), mask)
    prev_eff = torch.where(prev >= 0.0, prev, med)
    return alpha * prev_eff + (1.0 - alpha) * med


def keyframe_thresh_from_spaciousness(s: torch.Tensor) -> torch.Tensor:
    """Step map, reference odom.cc:1188-1199."""
    one = torch.ones_like(s)
    return torch.where(
        s > 20.0, 10.0 * one,
        torch.where(s > 10.0, 5.0 * one, torch.where(s > 5.0, one, 0.5 * one)),
    )
