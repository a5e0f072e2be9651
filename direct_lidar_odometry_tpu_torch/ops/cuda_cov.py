"""Fixed-radius neighbourhood moments: kernel K1 over a Morton-sorted
cloud, and the exhaustive kernel K6.

Counterpart of the JAX package's ``ops/pallas_cov.py``: the pruned path
(``_pruned_moments_one``, ``radius_moments_sorted``, ``moments_to_cov``),
the per-point covariances behind every scan's and every keyframe's normals,
and the exhaustive ``radius_moments``.

- :func:`cov_pruned` is kernel K1's wrapper. It takes the cloud's chunk
  AABBs; on a CUDA tensor it launches ``csrc/cov_pruned.cu``, which picks
  the candidate chunks of each 32-query sub-tile itself (as
  :func:`ops.cuda_nn.subtile_candidates` computes them); on a CPU tensor it
  runs :func:`cov_plain`, the exhaustive plain PyTorch version.
- :func:`radius_moments_sorted` is the public entry with the JAX package's
  signature.
- :func:`cov_exhaustive` is kernel K6's wrapper (``csrc/cov_exhaustive.cu``,
  every query against every valid target, no query mask; the targets are
  compacted on the device first, as for K5); its plain version is
  :func:`cov_plain` with every query valid. :func:`radius_moments` is the
  public entry.

Output rows are the 10 query-relative moments (n, sx, sy, sz, sxx, sxy,
sxz, syy, syz, szz) of d = t - q over valid targets with |d|^2 <= r^2.
Rows of invalid queries are zero in both routes.

K1 and its plain version take a leading lane dimension as K2 does
(``ops/cuda_nn.py``; the JAX package's ``_pruned_moments_batched``): [B,
Q, 3] queries over [B, T, 3] clouds, one launch, [B, Q, 10] moments.

``launches`` (K1) and ``exhaustive_launches`` (K6) count each wrapper's
calls per route (``"cuda"``/``"plain"``).
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_build
from direct_lidar_odometry_tpu_torch.ops.cuda_nn import (
    check_exhaustive_inputs,
    check_scan_stats,
    check_search_inputs,
    exhaustive_workspace,
    f32_radius2,
    plain_query_step,
    plain_scan_stats,
    plain_visits,
)
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane

N_MOMENTS = 10

launches = {"cuda": 0, "plain": 0}
exhaustive_launches = {"cuda": 0, "plain": 0}


def reset_launches() -> None:
    for counter in (launches, exhaustive_launches):
        for k in counter:
            counter[k] = 0


def cov_plain(
    points: torch.Tensor, mask: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exhaustive radius moments.

    The radius test evaluates d2 = (dx*dx + dy*dy) + dz*dz like the kernel,
    so both select the same neighbours. [Q, 10] f32; with a leading lane
    dimension [B, Q, 10], lane by lane.
    """
    if queries.dim() == 3:
        return per_lane(cov_plain, points, mask, queries, query_mask, radius,
                        lanes=queries.shape[0])
    r2 = f32_radius2(radius)
    q_total = queries.shape[0]
    out = torch.zeros((q_total, N_MOMENTS), dtype=torch.float32, device=queries.device)
    tx, ty, tz = points[:, 0], points[:, 1], points[:, 2]
    step = plain_query_step(points.shape[0], queries.device)
    for s in range(0, q_total, step):
        q = queries[s:s + step]
        dx = tx - q[:, 0:1]
        dy = ty - q[:, 1:2]
        dz = tz - q[:, 2:3]
        d2 = dx * dx + dy * dy
        d2 = d2 + dz * dz
        w = ((d2 <= r2) & mask[None, :]).to(torch.float32)
        wdx, wdy, wdz = w * dx, w * dy, w * dz
        out[s:s + step] = torch.stack(
            [
                w.sum(1), wdx.sum(1), wdy.sum(1), wdz.sum(1),
                (wdx * dx).sum(1), (wdx * dy).sum(1), (wdx * dz).sum(1),
                (wdy * dy).sum(1), (wdy * dz).sum(1), (wdz * dz).sum(1),
            ],
            dim=1,
        )
    return out * query_mask[:, None]


def cov_pruned(
    points: torch.Tensor, mask: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor,
    radius: float, visits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Wrapper of kernel K1: [Q, 10] moments as :func:`cov_plain`.

    points [T,3] f32 Morton-sorted, T % 512 == 0 and T <= 512 * 1024;
    chunk_lo/chunk_hi its [3, T//512] masked chunk AABBs; queries [Q,3] f32
    with Q % 128 == 0. The kernel selects the candidate chunks of each
    32-query sub-tile itself; ``visits`` (optional, int32 [Q // 32])
    receives each sub-tile's candidate count. A CUDA tensor launches the
    kernel on the current stream (no allocation inside, no
    synchronization); a CPU tensor runs the plain version and fills
    ``visits`` from :func:`ops.cuda_nn.subtile_candidates`. With a leading
    lane dimension on every argument, one launch covers B independent
    clouds and returns [B, Q, 10].
    """
    lanes = check_search_inputs(queries, query_mask, points, mask, chunk_lo, chunk_hi, visits)
    if queries.device.type == "cpu":
        launches["plain"] += 1
        plain_visits(visits, queries, query_mask, chunk_lo, chunk_hi, radius)
        return cov_plain(points, mask, queries, query_mask, radius)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    q_total = queries.shape[-2]
    out = torch.empty(queries.shape[:-1] + (N_MOMENTS,), dtype=torch.float32,
                      device=queries.device)
    with torch.cuda.device(queries.device):
        err = cuda_build.library().dlo_cov_pruned(
            queries.data_ptr(), query_mask.data_ptr(), points.data_ptr(), mask.data_ptr(),
            chunk_lo.data_ptr(), chunk_hi.data_ptr(), q_total, chunk_lo.shape[-1], lanes,
            f32_radius2(radius), out.data_ptr(), None if visits is None else visits.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream,
        )
    cuda_build.check(err, "cov_pruned")
    launches["cuda"] += 1
    return out


def radius_moments_sorted(
    points: torch.Tensor,
    mask: torch.Tensor,
    chunk_lo: torch.Tensor,
    chunk_hi: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Pruned radius moments over a Morton-sorted cloud. [Q, 10].

    ``chunk_lo``/``chunk_hi`` are the cloud's [3, T//512] chunk AABBs.
    Matches the exhaustive moments for every valid query. Every argument
    may carry a leading lane dimension [B] ([B, Q, 10], one launch).
    """
    return cov_pruned(points, mask, queries, query_mask, chunk_lo, chunk_hi, radius)


def cov_exhaustive(
    points: torch.Tensor, mask: torch.Tensor, queries: torch.Tensor, radius: float,
    stats: torch.Tensor | None = None,
) -> torch.Tensor:
    """Wrapper of kernel K6: [Q, 10] moments of every query (no query mask)
    over the valid points within ``radius`` (inclusive), as :func:`cov_plain`
    with every query valid. queries [Q,3] f32 with Q % 128 == 0; points of
    any count, in any order. ``stats`` (optional, int32 [2]) receives the
    valid points' count and the chunk scans of the grid, as
    :func:`ops.cuda_nn.nn1_exhaustive` fills it. A CUDA tensor launches the
    pre-pass, the scan and the merge on the current stream (no
    synchronization, no host read of the count)."""
    check_exhaustive_inputs(queries, points, mask)
    check_scan_stats(stats, queries)
    q_total = queries.shape[0]
    if queries.device.type == "cpu":
        exhaustive_launches["plain"] += 1
        plain_scan_stats(stats, q_total, mask)
        every = torch.ones((q_total,), dtype=torch.bool, device=queries.device)
        return cov_plain(points, mask, queries, every, radius)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    n_splits, dense, stats = exhaustive_workspace(queries, points, stats)
    part = torch.empty((n_splits, q_total, N_MOMENTS), dtype=torch.float32, device=queries.device)
    out = torch.empty((q_total, N_MOMENTS), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        err = cuda_build.library().dlo_cov_exhaustive(
            queries.data_ptr(), points.data_ptr(), mask.data_ptr(), q_total,
            points.shape[0], n_splits, f32_radius2(radius), dense.data_ptr(),
            stats.data_ptr(), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream,
        )
    cuda_build.check(err, "cov_exhaustive")
    exhaustive_launches["cuda"] += 1
    return out


def radius_moments(
    points: torch.Tensor, mask: torch.Tensor, queries: torch.Tensor, radius: float,
) -> torch.Tensor:
    """[T,3], [T], [Q,3] -> [Q,10] raw relative moments within ``radius``
    over the valid points, for every query (the JAX package's exhaustive
    ``radius_moments``)."""
    return cov_exhaustive(points, mask, queries, radius)


def moments_to_cov(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., Q, 10] -> (cov [..., Q, 3, 3], count [..., Q]). Query-relative,
    so well-conditioned."""
    n = torch.clamp(m[..., 0], min=1.0)
    mu = m[..., 1:4] / n[..., None]
    sxx, sxy, sxz = m[..., 4] / n, m[..., 5] / n, m[..., 6] / n
    syy, syz, szz = m[..., 7] / n, m[..., 8] / n, m[..., 9] / n
    exx = sxx - mu[..., 0] * mu[..., 0]
    exy = sxy - mu[..., 0] * mu[..., 1]
    exz = sxz - mu[..., 0] * mu[..., 2]
    eyy = syy - mu[..., 1] * mu[..., 1]
    eyz = syz - mu[..., 1] * mu[..., 2]
    ezz = szz - mu[..., 2] * mu[..., 2]
    row0 = torch.stack([exx, exy, exz], dim=-1)
    row1 = torch.stack([exy, eyy, eyz], dim=-1)
    row2 = torch.stack([exz, eyz, ezz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2), m[..., 0]
