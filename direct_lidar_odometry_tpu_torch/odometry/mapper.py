"""Map aggregation — the reference MapNode, in-process.

Counterpart of the JAX package's ``odometry/mapper.py`` (reference
``dlo::MapNode``, ``src/dlo/map.cc:19-131``): the keyframe ring already
holds every keyframe cloud, so the map is a pure function of the odometry
state: concatenate the keyframe clouds and voxel-downsample them.
:func:`build_map_xyzi` is the intensity-carrying twin on the host, from
the runner's sidecar of xyzi keyframe scans (PointXYZI parity).
"""

from __future__ import annotations

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud
from direct_lidar_odometry_tpu_torch.io.hostprep import voxel_mean_xyzi
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


def _quat_to_rotmat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def build_map_xyzi(
    kf_scans: dict[int, np.ndarray], positions: np.ndarray, quats: np.ndarray, leaf_size: float,
) -> np.ndarray:
    """Intensity-carrying map export (host side): ``kf_scans`` maps a ring
    slot to its sensor-frame [M, 4] xyzi keyframe scan (the runner's
    sidecar); ``positions``/``quats`` are the CURRENT keyframe poses, so a
    loop-closure re-anchoring shows. Each scan is moved to the world frame
    (float64), the scans are concatenated and xyz AND intensity are
    voxel-averaged at ``leaf_size`` (reference ``map.cc:100-131`` with
    ``pcl::PointXYZI``). Returns [P, 4]."""
    parts = []
    for slot, scan in sorted(kf_scans.items()):
        if len(scan) == 0:
            continue
        r = _quat_to_rotmat_np(np.asarray(quats[slot], np.float64))
        t = np.asarray(positions[slot], np.float64)
        world = scan[:, :3].astype(np.float64) @ r.T + t
        parts.append(np.concatenate([world.astype(np.float32), scan[:, 3:4]], axis=1))
    if not parts:
        return np.zeros((0, 4), np.float32)
    return voxel_mean_xyzi(np.concatenate(parts, axis=0), leaf_size)
