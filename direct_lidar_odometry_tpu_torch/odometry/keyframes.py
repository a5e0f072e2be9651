"""Keyframe spawning.

Counterpart of the JAX package's ``odometry/keyframes.py``, reference
``updateKeyframes`` (``odom.cc:1097-1181``). The decision chain
(``odom.cc:1143-1153``) reduces to
``new = (dd > threshD) or (theta > threshR and num_nearby <= 1)``; on spawn
the world-transformed scan is submap-voxelized and stored with its pose
and normals (Z-ordered, with radius normals, on the pruned-kernel backends;
k-NN normals on "brute" and "hashgrid"). The ring is written in place (see
``state.py``).

:func:`decide`, :func:`insert` and :func:`make_keyframe_cloud` also take a
ring with a leading lane dimension (the batched step);
:func:`maybe_spawn_batched` is the batched twin of :func:`maybe_spawn`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE, PointCloud
from direct_lidar_odometry_tpu_torch.ops import morton, voxel
from direct_lidar_odometry_tpu_torch.odometry.state import KeyframeStore
from direct_lidar_odometry_tpu_torch.registration import covariance, gicp
from direct_lidar_odometry_tpu_torch.utils import sync
from direct_lidar_odometry_tpu_torch.utils.lanes import lane_rows, lanes_where


class KeyframeDecision(NamedTuple):
    spawn: torch.Tensor        # bool
    closest_dist: torch.Tensor  # f32
    num_nearby: torch.Tensor   # int32


def decide(
    kf: KeyframeStore,
    position: torch.Tensor,
    quat: torch.Tensor,
    thresh_dist: torch.Tensor,
    thresh_rot_deg: float,
) -> KeyframeDecision:
    """Reference odom.cc:1104-1153 (device tensors, no host read). With B
    lanes (a batched ring, position [B, 3], quat [B, 4], thresh_dist [B])
    each lane's decision, in [B] fields."""
    kmask = torch.arange(kf.capacity, device=kf.count.device) < kf.count[..., None]
    d = torch.linalg.norm(kf.positions - position[..., None, :], dim=-1)
    d = torch.where(kmask, d, torch.inf)
    num_nearby = torch.sum((d <= thresh_dist[..., None] * 1.5) & kmask, dim=-1).to(torch.int32)
    closest = lane_rows(torch.argmin(d, dim=-1))
    dd = d[closest]
    theta_deg = se3.quat_angle_deg(quat, kf.quats[closest])
    spawn = (dd > thresh_dist) | ((theta_deg > thresh_rot_deg) & (num_nearby <= 1))
    # no keyframes yet -> always spawn
    spawn = spawn | (kf.count == 0)
    return KeyframeDecision(spawn=spawn, closest_dist=dd, num_nearby=num_nearby)


def make_keyframe_cloud(
    scan: PointCloud, pose: torch.Tensor, cfg: DloConfig, backend: str | None = None
) -> tuple[PointCloud, covariance.Normals]:
    """World-transform the scan, submap-voxelize and recompute normals
    (reference odom.cc:1155-1174). On the pruned-kernel backends the cloud
    is Z-ordered and its normals use radius 3 x the submap voxel; on
    "brute" and "hashgrid" they use the k-NN of ``gicp.s2s`` (the
    reference computes keyframe covariances through its S2S instance,
    odom.cc:1172-1174). With B lanes (scan [B, N, 3], pose [B, 4, 4]), each
    lane's cloud ([B, Nk, ...]) on every backend."""
    backend = backend or resolve_backend(cfg)
    world_pts = se3.transform_points(pose, scan.points)
    world_pts = torch.where(scan.mask[..., None], world_pts, PAD_VALUE)
    c = PointCloud(points=world_pts, mask=scan.mask)
    nk = cfg.shapes.n_keyframe
    if cfg.preprocessing.voxel_submap.use:
        c = voxel.voxel_downsample(c, cfg.preprocessing.voxel_submap.res, out_capacity=nk)
    else:
        c = PointCloud(points=c.points[..., :nk, :].contiguous(),
                       mask=c.mask[..., :nk].contiguous())
    k = cfg.gicp.s2s.k_correspondences
    chunk = min(cfg.shapes.knn_query_chunk, nk)
    if backend == "brute":
        return c, covariance.estimate_normals_brute(c.points, c.mask, k=k, chunk=chunk)
    if not gicp.is_pallas(backend):
        return c, covariance.estimate_normals_twoscale(c.points, c.mask, k=k, chunk=chunk,
                                                       cap=cfg.shapes.cell_cap_knn)
    res = cfg.preprocessing.voxel_submap.res if cfg.preprocessing.voxel_submap.use else 0.5
    # Z-order the keyframe cloud: the pruned moment kernel needs it, and it
    # keeps the stored cloud coherent for submap assembly
    zp, zm = morton.sort_cloud(c.points, c.mask)
    c = PointCloud(points=zp, mask=zm)
    clo, chi = morton.chunk_aabbs(c.points, c.mask, morton.TARGET_CHUNK)
    nrm = covariance.estimate_normals_radius_sorted(c.points, c.mask, clo, chi, radius=3.0 * res)
    return c, nrm


def _eviction_slot(positions: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """Slot to overwrite when the ring is full: of the densest keyframe pair
    (smallest pairwise distance; the first in row-major order on ties), the
    member farther from the incoming position. ``positions`` [K, 3], or n
    rings [n, K, 3] with ``position`` [n, 3] and one slot a ring."""
    k = positions.shape[-2]
    d2 = torch.sum((positions[..., :, None, :] - positions[..., None, :, :]) ** 2, dim=-1)
    eye = torch.eye(k, dtype=torch.bool, device=d2.device)
    d2 = d2 + torch.where(eye, torch.inf, 0.0)
    flat = torch.argmin(d2.flatten(-2), dim=-1)
    i, j = flat // k, flat % k
    di = torch.sum((positions[lane_rows(i)] - position) ** 2, dim=-1)
    dj = torch.sum((positions[lane_rows(j)] - position) ** 2, dim=-1)
    return torch.where(di > dj, i, j)


def insert(
    kf: KeyframeStore,
    position: torch.Tensor,
    quat: torch.Tensor,
    cloud: PointCloud,
    normals: covariance.Normals,
    seq: torch.Tensor | None = None,
    health: torch.Tensor | None = None,
    lanes: torch.Tensor | None = None,
) -> tuple[KeyframeStore, torch.Tensor, torch.Tensor]:
    """Write a keyframe IN PLACE at ``count``; when the ring is full, evict
    the most redundant keyframe (:func:`_eviction_slot`) instead.

    Returns (store, evicted: bool tensor, slot: int32 tensor). The caller
    must invalidate any cached submap when ``evicted`` is true.

    Into a batched store, row i of ``position`` [n, 3], ``quat``, ``cloud``
    ([n, Nk, ...]), ``normals``, ``seq`` [n] (required) and ``health`` [n]
    goes to the ring of lane ``lanes[i]`` (every lane in order when
    ``lanes`` is None); evicted and slot are then [n].
    """
    if kf.count.dim() and lanes is None:
        lanes = torch.arange(kf.count.shape[0], device=kf.count.device)
    count = kf.count if lanes is None else kf.count[lanes]
    positions = kf.positions if lanes is None else kf.positions[lanes]
    full = count >= kf.capacity
    idx = torch.where(full, _eviction_slot(positions, position), count.to(torch.int64))
    idx = torch.clamp(idx, 0, kf.capacity - 1)
    # monotonic insertion id (the pipeline passes the spawn frame index)
    # and spawn-frame health (0 = unknown)
    seq_val = torch.as_tensor(
        torch.max(kf.seq) + 1 if seq is None else seq, dtype=torch.int32, device=idx.device
    )
    health_val = torch.as_tensor(
        0.0 if health is None else health, dtype=torch.float32, device=idx.device
    )
    for arr, val in (
        (kf.positions, position), (kf.quats, quat),
        (kf.points, cloud.points), (kf.masks, cloud.mask),
        (kf.normals, normals.normals), (kf.normals_valid, normals.valid),
        (kf.seq, seq_val), (kf.health, health_val),
    ):
        if lanes is None:
            arr.index_copy_(0, idx.reshape(1), val.to(arr.dtype).reshape((1,) + arr.shape[1:]))
        else:
            arr.index_put_((lanes, idx), val.to(arr.dtype))
    new_count = torch.where(full, count, count + 1)
    if lanes is not None:
        new_count = kf.count.index_put((lanes,), new_count)
    return kf._replace(count=new_count), full, idx.to(torch.int32)


def maybe_spawn(
    kf: KeyframeStore,
    scan: PointCloud,
    pose: torch.Tensor,
    cfg: DloConfig,
    thresh_dist: torch.Tensor,
    seq: torch.Tensor | None = None,
    health: torch.Tensor | None = None,
    backend: str | None = None,
) -> tuple[KeyframeStore, bool, torch.Tensor, torch.Tensor]:
    """Full updateKeyframes step. Returns (store, spawned, evicted, slot);
    slot is the written ring index, or -1 if no keyframe spawned. One host
    read (the spawn decision) replaces the JAX package's ``lax.cond``."""
    position = se3.se3_translation(pose)
    quat = se3.rotmat_to_quat(se3.se3_rotation(pose))
    dec = decide(kf, position, quat, thresh_dist, cfg.keyframe.thresh_rot)
    if not sync.read(dec.spawn):
        no = torch.zeros((), dtype=torch.bool, device=pose.device)
        return kf, False, no, torch.full((), -1, dtype=torch.int32, device=pose.device)
    cloud, nrm = make_keyframe_cloud(scan, pose, cfg, backend)
    new_kf, evicted, slot = insert(kf, position, quat, cloud, nrm, seq=seq, health=health)
    return new_kf, True, evicted, slot


def maybe_spawn_batched(
    kf: KeyframeStore,
    scan: PointCloud,
    pose: torch.Tensor,
    cfg: DloConfig,
    thresh_dist: torch.Tensor,
    seq: torch.Tensor,
    health: torch.Tensor,
    backend: str | None = None,
) -> tuple[KeyframeStore, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`maybe_spawn` over B lanes (scan [B, N, ...], pose [B, 4, 4],
    thresh_dist, seq and health [B]). One host read of the [B] decisions
    replaces the JAX package's ``lax.cond`` under ``vmap``: when no lane
    spawns nothing more runs; else the spawning lanes are gathered, their
    keyframe clouds built together and written into their rings. Returns
    (store, spawned [B] bool, evicted [B] bool, slot [B] int32, -1 where
    none)."""
    position = se3.se3_translation(pose)
    quat = se3.rotmat_to_quat(se3.se3_rotation(pose))
    dec = decide(kf, position, quat, thresh_dist, cfg.keyframe.thresh_rot)
    evicted = torch.zeros_like(dec.spawn)
    slot = torch.full(dec.spawn.shape, -1, dtype=torch.int32, device=pose.device)
    n = sum(sync.read(dec.spawn))
    if n:
        lanes = lanes_where(dec.spawn, n)
        sub = PointCloud(points=scan.points[lanes], mask=scan.mask[lanes])
        cloud, nrm = make_keyframe_cloud(sub, pose[lanes], cfg, backend)
        kf, ev, sl = insert(kf, position[lanes], quat[lanes], cloud, nrm, seq=seq[lanes],
                            health=health[lanes], lanes=lanes)
        evicted = evicted.index_copy(0, lanes, ev)
        slot = slot.index_copy(0, lanes, sl)
    return kf, dec.spawn, evicted, slot
