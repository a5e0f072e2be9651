"""Voxel-grid centroid downsampling as a sort/segment-mean.

Counterpart of the JAX package's ``ops/voxel.py`` (replaces
``pcl::VoxelGrid``, reference ``odom.cc:126-127, 459-463``):

1. quantize points to integer voxel coordinates relative to the masked
   min corner (clamped to 1024 cells per axis);
2. sort by a key that is bijective with the voxel, so one sort groups
   equal voxels;
3. mark segment starts and number segments by prefix sum;
4. centroid = sum / count, emitted compacted to the front.

The reference's keys and Bresenham products are uint32; here they are
int64 holding the same values, with explicit 32-bit wraparound where the
reference relies on it (:func:`_scramble`). Sorts are stable; the
reference's ``lax.sort`` leaves the order of equal keys unspecified, so
outputs agree with it as sets (centroids to float rounding), not slot by
slot. Dropped points go to slot ``cap``, which is discarded.

A voxel's sum is the difference of two float64 prefix sums over the
sorted points, not a float scatter-add: on the card ``index_add_`` of
floats accumulates through atomics in no fixed order, so two runs over the
same frames would differ in the last bits of the centroids and their
trajectories would drift apart.

Every function takes a leading lane dimension too ([B, N, 3] clouds, the
batched step): the sorts run along each lane's rows, the segment scatters
go to per-lane slots (``lane * (cap + 1) + slot``) and the float64 prefix
scan runs along each lane's rows over its kept points only, so a lane gives
what the same cloud gives alone.
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE, PointCloud, gather_rows
from direct_lidar_odometry_tpu_torch.ops import morton

_GRID_DIM = 1024  # cells per axis; 1024^3 < 2^31 keeps linear ids in int32
_INT32_MAX = 2**31 - 1
_MASK32 = 0xFFFFFFFF


def _voxel_coords(points: torch.Tensor, mask: torch.Tensor, res: float) -> torch.Tensor:
    masked = torch.where(mask[..., None], points, PAD_VALUE)
    origin = torch.amin(masked, dim=-2, keepdim=True)
    coords = torch.floor((points - origin) / res).to(torch.int64)
    return torch.clamp(coords, 0, _GRID_DIM - 1)


def voxel_ids(points: torch.Tensor, mask: torch.Tensor, res: float) -> torch.Tensor:
    """Collision-free linear voxel id per point; invalid points get INT32_MAX."""
    c = _voxel_coords(points, mask, res)
    ids = c[..., 0] + _GRID_DIM * (c[..., 1] + _GRID_DIM * c[..., 2])
    return torch.where(mask, ids, _INT32_MAX)


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    """(h * const) mod 2^32 for h < 2^32, without int64 overflow: the
    constant is split into 16-bit halves so no partial product exceeds 2^48."""
    lo = h * (const & 0xFFFF)
    hi = ((h * (const >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _scramble(ids: torch.Tensor) -> torch.Tensor:
    """Murmur-style bijective mix of voxel ids, in uint32 arithmetic."""
    h = ids.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _segment_mean(
    spts: torch.Tensor, slot: torch.Tensor, cap: int
) -> PointCloud:
    """Mean of the sorted points per voxel slot in [0, cap) (slot ``cap`` =
    dropped), emitted compacted to the front. The rows of one slot are
    contiguous, so its sum is ``prefix[last + 1] - prefix[last + 1 - count]``
    over float64 prefix sums of the kept rows: the same bits on every run.
    Dropped rows are zeroed first (the 1e6 pad would cost the prefix its
    precision). With a lane dimension ([B, n, 3], [B, n]) each lane's slots
    are counted apart (flat index ``lane * (cap + 1) + slot``) and its
    prefix runs along its own rows."""
    n = spts.shape[-2]
    lead = slot.shape[:-1]
    dev = spts.device
    slot = torch.clamp(slot, max=cap)
    flat = slot
    if lead:
        flat = (slot + (cap + 1) * torch.arange(lead[0], device=dev)[:, None]).reshape(-1)
    cells = (lead[0] if lead else 1) * (cap + 1)
    counts = torch.zeros((cells,), dtype=torch.int64, device=dev)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.int64, device=dev))  # exact in any order
    last = torch.full((cells,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, torch.arange(n, device=dev).expand(slot.shape).reshape(-1),
                         reduce="amax")
    prefix = torch.zeros(lead + (n + 1, 3), dtype=torch.float64, device=dev)
    prefix[..., 1:, :] = torch.cumsum(
        torch.where((slot < cap)[..., None], spts, 0.0).to(torch.float64), dim=-2)
    counts = counts.reshape(lead + (cap + 1,))[..., :cap]
    last = last.reshape(lead + (cap + 1,))[..., :cap]
    sums = gather_rows(prefix, last + 1) - gather_rows(prefix, last + 1 - counts)
    out_mask = counts > 0
    centroids = (sums / torch.clamp(counts, min=1)[..., None]).to(torch.float32)
    centroids = torch.where(out_mask[..., None], centroids, PAD_VALUE)
    return PointCloud(points=centroids, mask=out_mask)


def voxel_downsample_morton(
    cloud: PointCloud, res: float, out_capacity: int | None = None
) -> PointCloud:
    """Centroid voxel filter emitting the output in Z (Morton) order.

    The sort key is the Morton code of the integer voxel coordinates, which
    is bijective with the voxel, so ONE sort both groups voxels and
    Z-orders the centroids for the pruned kernels. Capacity overflow keeps
    a spatially uniform subset: segments are Bresenham-subsampled along the
    Z-curve (``slot = floor(seg * cap / S)``, keep iff the floor
    increments).
    """
    n = cloud.capacity
    cap = out_capacity or n
    if (n - 1) * cap >= 2**32:
        raise ValueError(f"Bresenham products overflow 32 bits: n={n}, cap={cap}")
    cu = _voxel_coords(cloud.points, cloud.mask, res)
    code = torch.where(cloud.mask, morton.interleave3(cu), morton.INVALID_CODE)

    scode, order = torch.sort(code, stable=True)
    spts = gather_rows(cloud.points, order)
    svalid = scode != morton.INVALID_CODE
    first = torch.ones_like(svalid)
    first[..., 1:] = scode[..., 1:] != scode[..., :-1]
    first = first & svalid
    seg = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    s_total = torch.clamp(torch.sum(first.to(torch.int64), dim=-1, keepdim=True), min=1)

    # Bresenham stride over Z-ordered segments when S > cap: kept segments
    # get strictly increasing slots in [0, cap); dropped ones go to `cap`
    prod = seg * cap
    kept = (prod % s_total) < cap
    slot_over = prod // s_total
    slot = torch.where(
        s_total > cap, torch.where(kept, slot_over, cap), seg
    )
    slot = torch.where(svalid, slot, cap)
    return _segment_mean(spts, slot, cap)


def voxel_downsample(
    cloud: PointCloud, res: float, out_capacity: int | None = None
) -> PointCloud:
    """Centroid voxel filter, output compacted to the front in scrambled-id
    order: if more voxels are occupied than ``out_capacity``, the overflow
    drops a spatially uniform subset (ordering by raw id would keep one
    corner of the scene)."""
    n = cloud.capacity
    cap = out_capacity or n
    ids = voxel_ids(cloud.points, cloud.mask, res)
    # _scramble is bijective: sorting by the scrambled key alone groups
    # equal ids and randomizes group order. Invalid points share one key
    # (INT32_MAX's) and are dropped by the svalid gating below.
    _, order = torch.sort(_scramble(ids), stable=True)
    sids = gather_rows(ids, order)
    spts = gather_rows(cloud.points, order)
    svalid = gather_rows(cloud.mask, order)
    first = torch.ones_like(svalid)
    first[..., 1:] = sids[..., 1:] != sids[..., :-1]
    first = first & svalid
    slot = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    slot = torch.where(svalid, slot, cap)
    return _segment_mean(spts, slot, cap)
