"""Fused GICP linearization (kernel K3): 1-NN search, PLANE Mahalanobis and
the H/b sums in one pass.

Counterpart of the JAX package's ``ops/pallas_gicp.py``
(``fused_linearize``, ``FusedLinearization``), the linearization of the
``"pallas_fused"`` backend.

- :func:`fused_linearize_pruned` is the kernel's wrapper. On a CUDA tensor
  it launches ``csrc/fused_linearize.cu``, whose 32-query sub-tiles select
  their candidate chunks from the target's chunk AABBs themselves (K2's
  search); on a CPU tensor it runs :func:`fused_linearize_plain`, the plain
  PyTorch version (exhaustive 1-NN, the same per-query maths, the same
  per-sub-tile sums and the kernel's selection counts). Nothing falls back
  from one to the other.
- :func:`fused_linearize` is the public entry with the JAX package's
  signature: it runs the kernel over the sub-tiles of ``query_weight`` (not
  of the source mask) and unpacks the row sums into H [6,6], b [6], the
  error, n_corr and the two selection diagnostics, plus the frozen payload
  the LM gain test needs.

Per-sub-tile row layout of ``hb [Q // 32, 32]`` (summed over the rows by
the caller):
  0:6    upper triangle of H_tl = sum w S^T M S  (00, 01, 02, 11, 12, 22)
  6:15   S M, row-major (H_tr = -sum S^T M = +sum S M)
  15:21  upper triangle of H_br = sum w M
  21:27  b = [sum S^T M e, -sum M e]
  27     error = sum e^T M e
  28     n_corr = sum w
  29     chunks visited: squared AABB gap <= B, the largest bound of the
         sub-tile's weighted queries (a seed's d2 where seeded, else r^2)
  30     candidate chunks: squared AABB gap <= r^2
Payload ``pay [Q, 8]``: mu_b xyz, n_b xyz, w, best d2 (the search's final
bound: r^2 where nothing was found, 0 for queries of weight 0); zero
point and normal where w = 0.

K3 and its plain version take a leading lane dimension as K2 does
(``ops/cuda_nn.py``; the JAX package's ``_fused_linearize_batched``): [B,
Q, 3] sources against [B, T, 3] targets in one launch, ``hb`` [B, Q // 32,
32]. :func:`fused_linearize` sums each lane's rows with the unbatched
entry's own ``torch.sum`` (``utils/lanes.per_lane``), so a lane's H and b
equal those of its inputs launched alone, bit for bit.

``launches`` counts the wrapper's calls per route (``"cuda"``/``"plain"``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_build
from direct_lidar_odometry_tpu_torch.ops.cuda_nn import (
    SUB_TILE,
    check_search_inputs,
    f32_radius2,
    nn1_plain,
    subtile_gap2,
)
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane

N_SLOTS = 32
_QUERY_SLOTS = 29

launches = {"cuda": 0, "plain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class FusedLinearization(NamedTuple):
    """Unpacked fused-kernel results (see the module's row layout)."""

    h: torch.Tensor              # [6, 6]  (each field with a leading [B] for B lanes)
    b: torch.Tensor              # [6]
    error: torch.Tensor          # f32
    n_corr: torch.Tensor         # int32
    mu_b: torch.Tensor           # [Q, 3] frozen correspondence target points
    n_b: torch.Tensor            # [Q, 3] frozen correspondence target normals
    weight: torch.Tensor         # [Q] f32 0/1
    best_d2: torch.Tensor        # [Q]
    corr: torch.Tensor           # [Q] int32 target index, -1 = none
    bb_visits: torch.Tensor      # f32 chunks visited, summed over 32-query sub-tiles
    bb_candidates: torch.Tensor  # f32 candidate chunks at r, summed over sub-tiles


def _query_slots(p, m, mu_b, n_b, plane_eps: float) -> torch.Tensor:
    """Per-query slots 0-27 of a matched query (w = 1): the kernel's maths
    in the JAX kernel's order. [Q, 28]."""
    qx, qy, qz = p.unbind(-1)
    mx, my, mz = m.unbind(-1)
    nx, ny, nz = n_b.unbind(-1)
    a = 1.0 - plane_eps
    a00 = 2.0 - a * (nx * nx + mx * mx)
    a01 = -a * (nx * ny + mx * my)
    a02 = -a * (nx * nz + mx * mz)
    a11 = 2.0 - a * (ny * ny + my * my)
    a12 = -a * (ny * nz + my * mz)
    a22 = 2.0 - a * (nz * nz + mz * mz)
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    m00 = co00 * inv_det
    m01 = co01 * inv_det
    m02 = co02 * inv_det
    m11 = (a00 * a22 - a02 * a02) * inv_det
    m12 = (a01 * a02 - a00 * a12) * inv_det
    m22 = (a00 * a11 - a01 * a01) * inv_det
    ex, ey, ez = (mu_b - p).unbind(-1)
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    err = ex * mex + ey * mey + ez * mez

    def cross(ux, uy, uz):  # p x u
        return qy * uz - qz * uy, qz * ux - qx * uz, qx * uy - qy * ux

    t00, t10, t20 = cross(m00, m01, m02)
    t01, t11, t21 = cross(m01, m11, m12)
    t02, t12, t22 = cross(m02, m12, m22)
    d0y, d0z = m11 * qz - m12 * qy, m12 * qz - m22 * qy
    d1x, d1y, d1z = m02 * qx - m00 * qz, m12 * qx - m01 * qz, m22 * qx - m02 * qz
    d2x, d2y, d2z = m00 * qy - m01 * qx, m01 * qy - m11 * qx, m02 * qy - m12 * qx
    c0x = qy * d0z - qz * d0y
    c1x, c1y = qy * d1z - qz * d1y, qz * d1x - qx * d1z
    c2x, c2y = qy * d2z - qz * d2y, qz * d2x - qx * d2z
    btx, bty, btz = cross(mex, mey, mez)
    return torch.stack([
        -c0x, -c1x, -c2x, -c1y, -c2y, -(qx * d2y - qy * d2x),
        t00, t01, t02, t10, t11, t12, t20, t21, t22,
        m00, m01, m02, m11, m12, m22,
        -btx, -bty, -btz, -mex, -mey, -mez,
        err,
    ], dim=-1)


def seed_bounds(p_t, query_weight, seed, targets, target_mask, radius: float) -> torch.Tensor:
    """Each sub-tile's selection bound B in K3: the largest per-query bound
    over its weighted queries, the seed's d2 ((dx*dx + dy*dy) + dz*dz) where
    the seed names a valid target strictly inside r^2, r^2 otherwise; 0 for
    a sub-tile without a weighted query. f32 [Q // 32]."""
    r2 = f32_radius2(radius)
    j = seed.to(torch.int64)
    ok = query_weight & (j >= 0) & (j < targets.shape[0])
    j = torch.where(ok, j, 0)
    ok = ok & target_mask[j]
    d = p_t - targets[j]
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    seeded = ok & (d2 < r2)
    own = torch.where(query_weight, torch.where(seeded, d2, r2), 0.0)
    return own.reshape(-1, SUB_TILE).amax(dim=1)


def fused_linearize_plain(
    p_t, m_rot, query_weight, seed,
    targets, target_mask, target_normals, target_normals_valid,
    chunk_lo, chunk_hi, radius: float, plane_eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (hb [Q // 32, 32], pay [Q, 8], idx int32 [Q]).

    Exhaustive 1-NN (:func:`ops.cuda_nn.nn1_plain`, the kernel's distance
    and tie rule) over the queries of weight 1, then the kernel's per-query
    maths and per-sub-tile sums. The seed changes which chunks the kernel
    visits, never its result, so the exhaustive search ignores it; slots
    29/30 count the kernel's selection (:func:`ops.cuda_nn.subtile_gap2`
    against :func:`seed_bounds` and against r^2). With a leading lane
    dimension on every tensor, lane by lane: ([B, Q // 32, 32], [B, Q, 8],
    [B, Q]).
    """
    if p_t.dim() == 3:
        return per_lane(fused_linearize_plain, p_t, m_rot, query_weight, seed, targets,
                        target_mask, target_normals, target_normals_valid, chunk_lo, chunk_hi,
                        radius, plane_eps, lanes=p_t.shape[0])
    idx, d2 = nn1_plain(p_t, query_weight, targets, target_mask, radius)
    found = idx >= 0
    j = torch.clamp(idx, min=0).to(torch.int64)
    w = found & target_normals_valid[j]
    mu_b = torch.where(w[:, None], targets[j], 0.0)
    n_b = torch.where(w[:, None], target_normals[j], 0.0)
    wf = w.to(torch.float32)
    vals = torch.where(w[:, None], _query_slots(p_t, m_rot, mu_b, n_b, plane_eps), 0.0)
    n_sub = p_t.shape[0] // SUB_TILE
    sums = torch.cat([vals, wf[:, None]], dim=1).reshape(n_sub, SUB_TILE, _QUERY_SLOTS).sum(1)
    r2 = f32_radius2(radius)
    gap2 = subtile_gap2(p_t, query_weight, chunk_lo, chunk_hi)
    bounds = seed_bounds(p_t, query_weight, seed, targets, target_mask, radius)
    diag = torch.stack([(gap2 <= bounds[:, None]).sum(1), (gap2 <= r2).sum(1)], 1)
    hb = torch.cat([sums, diag.to(torch.float32), torch.zeros_like(sums[:, :1])], dim=1)
    best = torch.where(found, d2, torch.where(query_weight, r2, 0.0))
    pay = torch.cat([mu_b, n_b, wf[:, None], best[:, None]], dim=1)
    return hb, pay, torch.where(w, idx, -1)


def fused_linearize_pruned(
    p_t, m_rot, query_weight, seed,
    targets, target_mask, target_normals, target_normals_valid,
    chunk_lo, chunk_hi, radius: float, plane_eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wrapper of kernel K3: (hb [Q // 32, 32], pay [Q, 8], idx int32 [Q])
    as :func:`fused_linearize_plain`.

    p_t/m_rot [Q,3] f32 with Q % 128 == 0, query_weight [Q] bool, seed [Q]
    int32 (-1 = cold); targets/target_normals [T,3] f32 Morton-sorted with
    T % 512 == 0 and T <= 512 * 1024, target_mask/target_normals_valid [T]
    bool; chunk_lo/chunk_hi the targets' [3, T//512] masked chunk AABBs.
    The kernel selects the candidate chunks of each 32-query sub-tile of
    query_weight itself. A CUDA tensor launches the kernel on the current
    stream (no allocation inside, no synchronization). With a leading lane
    dimension [B] on every tensor, one launch covers B independent lanes:
    ([B, Q // 32, 32], [B, Q, 8], [B, Q]), indices local to each lane.
    """
    lanes = check_search_inputs(p_t, query_weight, targets, target_mask, chunk_lo, chunk_hi)
    extra = dict(m_rot=(m_rot, torch.float32, p_t.shape), seed=(seed, torch.int32, p_t.shape[:-1]),
                 target_normals=(target_normals, torch.float32, targets.shape),
                 target_normals_valid=(target_normals_valid, torch.bool, targets.shape[:-1]))
    for name, (t, dt, shape) in extra.items():
        if not t.is_contiguous() or t.device != p_t.device or t.dtype != dt or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape {tuple(shape)} "
                             f"on {p_t.device}")
    if p_t.device.type == "cpu":
        launches["plain"] += 1
        return fused_linearize_plain(p_t, m_rot, query_weight, seed, targets, target_mask,
                                     target_normals, target_normals_valid, chunk_lo, chunk_hi,
                                     radius, plane_eps)
    if p_t.device.type != "cuda":
        raise ValueError(f"unsupported device {p_t.device}")
    lead = p_t.shape[:-2]
    q_total = p_t.shape[-2]
    hb = torch.empty(lead + (q_total // SUB_TILE, N_SLOTS), dtype=torch.float32,
                     device=p_t.device)
    pay = torch.empty(lead + (q_total, 8), dtype=torch.float32, device=p_t.device)
    idx = torch.empty(lead + (q_total,), dtype=torch.int32, device=p_t.device)
    with torch.cuda.device(p_t.device):
        err = cuda_build.library().dlo_fused_linearize(
            p_t.data_ptr(), m_rot.data_ptr(), query_weight.data_ptr(), seed.data_ptr(),
            targets.data_ptr(), target_mask.data_ptr(), target_normals.data_ptr(),
            target_normals_valid.data_ptr(), chunk_lo.data_ptr(), chunk_hi.data_ptr(),
            q_total, chunk_lo.shape[-1], lanes, f32_radius2(radius),
            float(np.float32(1.0 - plane_eps)),
            hb.data_ptr(), pay.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(p_t.device).cuda_stream,
        )
    cuda_build.check(err, "fused_linearize")
    launches["cuda"] += 1
    return hb, pay, idx


def _unpack_h(sums: torch.Tensor) -> torch.Tensor:
    """H [..., 6, 6] from the summed row slots 0-20 ([..., 32])."""
    h00, h01, h02, h11, h12, h22 = sums[..., 0:6].unbind(-1)
    tr = sums[..., 6:15].reshape(sums.shape[:-1] + (3, 3))
    m00, m01, m02, m11, m12, m22 = sums[..., 15:21].unbind(-1)

    def sym3(a, b, c, d, e, f):
        return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, e], -1),
                            torch.stack([c, e, f], -1)], -2)

    h_tl = sym3(h00, h01, h02, h11, h12, h22)
    h_br = sym3(m00, m01, m02, m11, m12, m22)
    # the kernel emits S M = -S^T M; _linearize's h_tr = -sum S^T M = +sum S M
    return torch.cat([torch.cat([h_tl, tr], dim=-1), torch.cat([tr.mT, h_br], dim=-1)], dim=-2)


def fused_linearize(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    target_normals_valid: torch.Tensor,
    chunk_lo: torch.Tensor,
    chunk_hi: torch.Tensor,
    p_t: torch.Tensor,
    m_rot: torch.Tensor,
    query_weight: torch.Tensor,
    radius: float,
    plane_eps: float = 1e-3,
    seed_corr: torch.Tensor | None = None,
) -> FusedLinearization:
    """One GICP linearization pass over a Morton-sorted target cloud.

    ``p_t`` [Q,3] are the transformed source points, ``m_rot`` [Q,3] the
    rotated source normals ``R n_a``, ``query_weight`` [Q] bool the source
    mask & normals_valid. Returns H, b, the error, n_corr and the frozen
    payload (mu_b, n_b, weight, best_d2, corr). ``seed_corr`` [Q] (or None):
    previous-iteration correspondences that warm-start the search (they may
    shrink each sub-tile's chunk selection); the result is exactly the
    unseeded one. ``bb_visits`` / ``bb_candidates`` count chunks per
    32-query sub-tile: the kernel evaluates 32 * 512 * bb_visits pairs.
    With a leading lane dimension [B] on every tensor, one launch serves B
    lanes and every field gains the lane dimension (each lane's rows summed
    as the unbatched entry sums them).
    """
    p_t = p_t.contiguous()
    m_rot = m_rot.contiguous()
    if seed_corr is None:
        seed = torch.full(query_weight.shape, -1, dtype=torch.int32, device=p_t.device)
    else:
        seed = seed_corr.to(torch.int32).contiguous()
    hb, pay, corr = fused_linearize_pruned(
        p_t, m_rot, query_weight, seed, target_points, target_mask,
        target_normals, target_normals_valid, chunk_lo, chunk_hi, radius, plane_eps,
    )
    if hb.dim() == 3:
        sums = per_lane(torch.sum, hb, 0)
    else:
        sums = torch.sum(hb, dim=0)
    return FusedLinearization(
        h=_unpack_h(sums), b=sums[..., 21:27], error=sums[..., 27],
        n_corr=sums[..., 28].to(torch.int32), mu_b=pay[..., 0:3], n_b=pay[..., 3:6],
        weight=pay[..., 6], best_d2=pay[..., 7], corr=corr, bb_visits=sums[..., 29],
        bb_candidates=sums[..., 30],
    )
