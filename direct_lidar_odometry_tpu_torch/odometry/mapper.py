"""Map aggregation — the reference MapNode, in-process.

Counterpart of the JAX package's ``odometry/mapper.py`` (reference
``dlo::MapNode``, ``src/dlo/map.cc:19-131``): the keyframe ring already
holds every keyframe cloud, so the map is a pure function of the odometry
state: concatenate the keyframe clouds and voxel-downsample them.
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud
from direct_lidar_odometry_tpu_torch.odometry.state import KeyframeStore
from direct_lidar_odometry_tpu_torch.ops import voxel


def build_map(
    kf: KeyframeStore, leaf_size: float, out_capacity: int | None = None
) -> PointCloud:
    """All occupied keyframe clouds, voxel-downsampled at ``leaf_size``
    (the accumulate ``map.cc:121-131`` + timer downsample ``map.cc:100-114``
    pair). The output holds the same voxels as the JAX package's; their
    order within the cloud follows the port's stable sort."""
    k, nk, _ = kf.points.shape
    kmask = (torch.arange(k, device=kf.count.device) < kf.count)[:, None]
    flat = PointCloud(
        points=kf.points.reshape(k * nk, 3),
        mask=(kf.masks & kmask).reshape(k * nk),
    )
    return voxel.voxel_downsample(flat, leaf_size, out_capacity=out_capacity or k * nk)
