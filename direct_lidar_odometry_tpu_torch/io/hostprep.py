"""Host-side scan preprocessing (NaN/crop/voxel/Morton), native or numpy.

Counterpart of the JAX package's ``io/hostprep.py``. With
``DloConfig.host_preprocess`` the runner preprocesses each scan on the host
before the transfer: the device step then starts from <= n_scan voxel
centroids already in Z-order, which takes the raw scan's voxel sort and
prefix sums off the device and shrinks the wire format ~4x (the reference
preprocesses on the CPU that feeds its registration, ``odom.cc:443-465``).

:func:`preprocess_morton` runs the threaded C++ (``io/native.py``,
``dlo_preprocess_morton``) when the native library is available and the
numpy twin below otherwise — host code either way; :func:`implementation`
says which one runs. The numpy functions are copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np

from direct_lidar_odometry_tpu_torch.io import native

_GRID_DIM = 1024


def _part_bits_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(1023)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def _morton_codes(xyz: np.ndarray, res: float) -> np.ndarray:
    origin = xyz.min(axis=0)
    coords = np.clip(
        np.floor((xyz - origin) / res).astype(np.int64), 0, _GRID_DIM - 1
    ).astype(np.uint32)
    return (
        _part_bits_np(coords[:, 0])
        | (_part_bits_np(coords[:, 1]) << 1)
        | (_part_bits_np(coords[:, 2]) << 2)
    )


def _bresenham_keep(s: int, out_cap: int) -> np.ndarray:
    """Segments kept by an even stride along the Z-curve when s > out_cap
    (the device op's and the C++'s overflow policy)."""
    i = np.arange(s, dtype=np.uint64)
    return (i * np.uint64(out_cap)) % np.uint64(s) < np.uint64(out_cap)


def _preprocess_morton_numpy(
    points: np.ndarray, crop_size: float, res: float, out_cap: int
) -> np.ndarray:
    pts = np.asarray(points[:, :3], np.float32)
    keep = np.all(np.isfinite(pts), axis=1)
    if crop_size > 0:
        keep &= ~np.all(np.abs(pts) <= crop_size, axis=1)
    pts = pts[keep]
    if len(pts) == 0:
        return np.zeros((0, 3), np.float32)
    # np.unique sorts ascending = Morton order
    uniq, inv = np.unique(_morton_codes(pts, res), return_inverse=True)
    s = len(uniq)
    sums = np.zeros((s, 3), np.float64)
    np.add.at(sums, inv, pts)
    counts = np.bincount(inv, minlength=s).astype(np.float64)
    centroids = (sums / counts[:, None]).astype(np.float32)
    if s <= out_cap:
        return centroids
    return centroids[_bresenham_keep(s, out_cap)]


def implementation() -> str:
    """``"native"`` when :func:`preprocess_morton` runs the C++, else ``"numpy"``."""
    return "native" if native.available() else "numpy"


def preprocess_morton(
    points: np.ndarray, crop_size: float | None, res: float, out_cap: int
) -> np.ndarray:
    """[M, 3+] raw scan -> [<=out_cap, 3] Z-ordered voxel centroids."""
    crop = float(crop_size) if crop_size else 0.0
    if native.available():
        return native.preprocess_morton(points, crop, res, out_cap)
    return _preprocess_morton_numpy(points, crop, res, out_cap)


def voxel_mean_xyzi(pts: np.ndarray, res: float, out_cap: int | None = None) -> np.ndarray:
    """[M, 4] xyzi -> [S, 4] per-voxel mean of the coordinates AND the
    intensity, in Morton order (the reference gets this from
    ``pcl::VoxelGrid`` averaging every PointXYZI field, ``dlo/dlo.h:50``);
    overflow keeps the device op's Bresenham Z-curve stride."""
    pts = np.asarray(pts, np.float32)
    if len(pts) == 0:
        return pts.reshape(0, 4)
    uniq, inv = np.unique(_morton_codes(pts[:, :3], res), return_inverse=True)
    s = len(uniq)
    sums = np.zeros((s, 4), np.float64)
    np.add.at(sums, inv, pts[:, :4])
    counts = np.bincount(inv, minlength=s).astype(np.float64)
    out = (sums / counts[:, None]).astype(np.float32)
    if out_cap is not None and s > out_cap:
        out = out[_bresenham_keep(s, out_cap)]
    return out


def reduce_keyframe_scan_xyzi(
    points: np.ndarray, crop_size: float | None, scan_res: float | None,
    submap_res: float | None, out_cap: int,
) -> np.ndarray:
    """Raw [M, 4] xyzi scan -> the keyframe-cloud reduction, intensity kept
    (NaN/crop -> scan-res voxel -> submap-res voxel, as
    ``pipeline.preprocess_scan`` + ``keyframes.make_keyframe_cloud`` reduce
    the geometry), so the runner's intensity sidecar keeps the density of
    the device keyframe ring."""
    pts = np.asarray(points, np.float32)
    if pts.shape[1] < 4:
        pts = np.concatenate([pts[:, :3], np.zeros((len(pts), 1), np.float32)], axis=1)
    keep = np.all(np.isfinite(pts[:, :3]), axis=1)
    if crop_size:
        keep &= ~np.all(np.abs(pts[:, :3]) <= float(crop_size), axis=1)
    pts = pts[keep][:, :4]
    if scan_res:
        pts = voxel_mean_xyzi(pts, scan_res)
    if submap_res:
        pts = voxel_mean_xyzi(pts, submap_res, out_cap=out_cap)
    elif len(pts) > out_cap:
        pts = pts[:out_cap]
    return pts
