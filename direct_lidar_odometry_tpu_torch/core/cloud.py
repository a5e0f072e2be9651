"""Fixed-capacity masked point clouds.

``points: f32[N, 3]`` plus ``mask: bool[N]`` with a fixed capacity ``N``;
invalid slots hold :data:`PAD_VALUE`. Fixed capacities let the keyframe ring
and the submap cache be allocated once and written in place. The batched
step (``parallel/batched.py``) carries B independent clouds as
``points: f32[B, N, 3]``, ``mask: bool[B, N]``; :func:`gather_rows` reorders
either form.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.io import native
from direct_lidar_odometry_tpu_torch.utils import sync


class PointCloud(NamedTuple):
    """points: f32[N, 3]; mask: bool[N] (or [B, N, 3], [B, N] for B lanes).
    Invalid slots hold PAD_VALUE."""

    points: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]


# Padding coordinate for invalid slots: far outside any plausible scene so
# padded points can never be spurious nearest neighbors.
PAD_VALUE = 1e6


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` by index: ``x[idx]`` for a 1-D index, and for a [B, M]
    index into [B, N, ...] the rows of each lane, ``x[b, idx[b]]``."""
    if idx.dim() == 1:
        return x[idx]
    lane = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lane, idx]


def make_cloud(points: torch.Tensor, mask: torch.Tensor | None = None) -> PointCloud:
    """A float32 cloud of ``points`` on their device, every point valid
    without ``mask``; invalid rows are set to PAD_VALUE."""
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    points = torch.where(mask[..., None], points, PAD_VALUE)
    return PointCloud(points=points.to(torch.float32), mask=mask)


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """The valid points as a dense [M, 3] numpy array (host side)."""
    return cloud.points.cpu().numpy()[cloud.mask.cpu().numpy()]


def compact(cloud: PointCloud) -> PointCloud:
    """Move the valid points to the front, in their order (a stable sort of
    the invalid flags), and set the tail to PAD_VALUE."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), dim=-1, stable=True)
    points = gather_rows(cloud.points, order)
    mask = torch.gather(cloud.mask, -1, order)
    points = torch.where(mask[..., None], points, PAD_VALUE)
    return PointCloud(points=points, mask=mask)


def concat_clouds(clouds: list[PointCloud], capacity: int | None = None) -> PointCloud:
    """Concatenate along the point axis (masks kept, not compacted); raises
    when ``capacity`` is given and the result has another."""
    out = PointCloud(points=torch.cat([c.points for c in clouds], dim=-2),
                     mask=torch.cat([c.mask for c in clouds], dim=-1))
    if capacity is not None and out.capacity != capacity:
        raise ValueError(f"concat capacity {out.capacity} != requested {capacity}")
    return out


def from_numpy(points: np.ndarray, capacity: int, device="cuda") -> PointCloud:
    """Pad/truncate an [M, 3] numpy array into a capacity-N cloud."""
    points = np.asarray(points, dtype=np.float32)
    m = min(points.shape[0], capacity)
    out = np.full((capacity, 3), PAD_VALUE, dtype=np.float32)
    out[:m] = points[:m]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:m] = True
    return PointCloud(
        points=sync.upload(torch.from_numpy(out), device),
        mask=sync.upload(torch.from_numpy(mask), device),
    )


class QuantizedScan(NamedTuple):
    """Host->device wire format: uint16 coordinates with a per-frame affine
    (lo, scale) per axis, and the count of valid leading points."""

    q: np.ndarray       # [N, 3] uint16 quantized coordinates
    lo: np.ndarray      # [3] f32 per-axis offset
    scale: np.ndarray   # [3] f32 per-axis step
    count: np.ndarray   # [] int32 number of valid (leading) points


def quantize_for_transfer(points: np.ndarray, capacity: int) -> QuantizedScan:
    """Host side: encode an [M, 3] scan into the uint16 wire format, with
    the threaded C++ encoder when the native host library is available
    (``io/native.py``), as in the JAX package, and numpy otherwise."""
    points = np.asarray(points, dtype=np.float32)
    if native.available():
        q, lo, scale, m = native.quantize(points, capacity)
        return QuantizedScan(q=q, lo=lo, scale=scale, count=m)
    m = min(points.shape[0], capacity)
    pts = points[:m]
    if m > 0:
        lo = pts.min(axis=0)
        extent = np.maximum(pts.max(axis=0) - lo, 1e-6)
    else:
        lo = np.zeros(3, np.float32)
        extent = np.ones(3, np.float32)
    scale = (extent / 65535.0).astype(np.float32)
    q = np.zeros((capacity, 3), dtype=np.uint16)
    if m > 0:
        q[:m] = np.clip(np.rint((pts - lo) / scale), 0, 65535).astype(np.uint16)
    return QuantizedScan(
        q=q, lo=lo.astype(np.float32), scale=scale, count=np.int32(m),
    )


def dequantize(
    q: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, count
) -> PointCloud:
    """Device side: decode the wire format back into a masked cloud.

    ``q`` holds the uint16 words; it may arrive as int16 (the same bits,
    since CUDA tensors of dtype uint16 support few ops), so the words are
    widened to int32 and masked to 16 bits before the float conversion.
    """
    n = q.shape[-2]
    words = q.to(torch.int32) & 0xFFFF
    mask = torch.arange(n, device=q.device) < count
    pts = words.to(torch.float32) * scale + lo
    pts = torch.where(mask[..., None], pts, PAD_VALUE)
    return PointCloud(points=pts, mask=mask)

