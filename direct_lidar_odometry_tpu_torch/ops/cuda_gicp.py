"""Fused GICP linearization (kernel K3): 1-NN search, PLANE Mahalanobis and
the H/b sums in one pass.

Counterpart of the JAX package's ``ops/pallas_gicp.py``
(``fused_linearize``, ``FusedLinearization``), the linearization of the
``"pallas_fused"`` backend.

- :func:`fused_linearize_pruned` is the kernel's wrapper. On a CUDA tensor
  it launches ``csrc/fused_linearize.cu`` over the query tiles' candidate
  chunk lists; on a CPU tensor it runs :func:`fused_linearize_plain`, the
  plain PyTorch version (exhaustive 1-NN, the same per-query maths and the
  same per-tile sums). Nothing falls back from one to the other.
- :func:`fused_linearize` is the public entry with the JAX package's
  signature: it builds the candidate lists from the tiles of
  ``query_weight`` (not of the source mask), runs the kernel and unpacks
  the tile sums into H [6,6], b [6], the error, n_corr and the two
  branch-and-bound diagnostics, plus the frozen payload the LM gain test
  needs.

Per-tile row layout of ``hb [Qc, 32]`` (summed over tiles by the caller):
  0:6    upper triangle of H_tl = sum w S^T M S  (00, 01, 02, 11, 12, 22)
  6:15   S M, row-major (H_tr = -sum S^T M = +sum S M)
  15:21  upper triangle of H_br = sum w M
  21:27  b = [sum S^T M e, -sum M e]
  27     error = sum e^T M e
  28     n_corr = sum w
  29     chunks visited by the branch-and-bound
  30     candidate chunks listed
Payload ``pay [Q, 8]``: mu_b xyz, n_b xyz, w, best d2 (the search's final
bound: r^2 where nothing was found, 0 for queries of weight 0); zero
point and normal where w = 0.

``launches`` counts the wrapper's calls per route (``"cuda"``/``"plain"``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.ops import cuda_build, morton
from direct_lidar_odometry_tpu_torch.ops.cuda_nn import (
    CHUNK,
    TILE,
    _GAP_SCALE,
    candidate_chunks,
    check_kernel_inputs,
    f32_radius2,
    nn1_plain,
)

N_SLOTS = 32
_QUERY_SLOTS = 29

launches = {"cuda": 0, "plain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class FusedLinearization(NamedTuple):
    """Unpacked fused-kernel results (see the module's row layout)."""

    h: torch.Tensor              # [6, 6]
    b: torch.Tensor              # [6]
    error: torch.Tensor          # f32
    n_corr: torch.Tensor         # int32
    mu_b: torch.Tensor           # [Q, 3] frozen correspondence target points
    n_b: torch.Tensor            # [Q, 3] frozen correspondence target normals
    weight: torch.Tensor         # [Q] f32 0/1
    best_d2: torch.Tensor        # [Q]
    corr: torch.Tensor           # [Q] int32 target index, -1 = none
    bb_visits: torch.Tensor      # f32 total chunk visits across tiles
    bb_candidates: torch.Tensor  # f32 total candidate-list length across tiles


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


def fused_linearize_plain(
    p_t, m_rot, query_weight, seed,
    targets, target_mask, target_normals, target_normals_valid,
    cand, counts, radius: float, plane_eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (hb [Qc, 32], pay [Q, 8], idx int32 [Q]).

    Exhaustive 1-NN (:func:`ops.cuda_nn.nn1_plain`, the kernel's distance
    and tie rule) over the queries of weight 1, then the kernel's per-query
    maths and per-tile sums. The seed only tightens the kernel's search
    bound and never changes its result, so an exhaustive search ignores
    it; slot 29 counts every chunk as visited.
    """
    idx, d2 = nn1_plain(p_t, query_weight, targets, target_mask, radius)
    found = idx >= 0
    j = torch.clamp(idx, min=0).to(torch.int64)
    w = found & target_normals_valid[j]
    mu_b = torch.where(w[:, None], targets[j], 0.0)
    n_b = torch.where(w[:, None], target_normals[j], 0.0)
    wf = w.to(torch.float32)
    vals = torch.where(w[:, None], _query_slots(p_t, m_rot, mu_b, n_b, plane_eps), 0.0)
    q_total = p_t.shape[0]
    qc = q_total // TILE
    sums = torch.cat([vals, wf[:, None]], dim=1).reshape(qc, TILE, _QUERY_SLOTS).sum(1)
    n_chunks = -(-targets.shape[0] // CHUNK)
    diag = torch.stack([torch.full_like(sums[:, 0], float(n_chunks)), counts.to(torch.float32)], 1)
    hb = torch.cat([sums, diag, torch.zeros_like(sums[:, :1])], dim=1)
    r2 = f32_radius2(radius)
    best = torch.where(found, d2, torch.where(query_weight, r2, 0.0))
    pay = torch.cat([mu_b, n_b, wf[:, None], best[:, None]], dim=1)
    return hb, pay, torch.where(w, idx, -1)


def fused_linearize_pruned(
    p_t, m_rot, query_weight, seed,
    targets, target_mask, target_normals, target_normals_valid,
    cand, counts, radius: float, plane_eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wrapper of kernel K3: (hb [Qc, 32], pay [Q, 8], idx int32 [Q]) as
    :func:`fused_linearize_plain`.

    p_t/m_rot [Q,3] f32 with Q % 128 == 0, query_weight [Q] bool, seed [Q]
    int32 (-1 = cold); targets/target_normals [T,3] f32 Morton-sorted with
    T % 512 == 0, target_mask/target_normals_valid [T] bool; cand/counts
    from :func:`ops.cuda_nn.candidate_chunks` over the tiles of
    query_weight. A CUDA tensor launches the kernel on the current stream
    (no allocation inside, no synchronization).
    """
    check_kernel_inputs(p_t, query_weight, targets, target_mask, cand, counts)
    extra = dict(m_rot=(m_rot, torch.float32, p_t.shape), seed=(seed, torch.int32, (p_t.shape[0],)),
                 target_normals=(target_normals, torch.float32, targets.shape),
                 target_normals_valid=(target_normals_valid, torch.bool, (targets.shape[0],)))
    for name, (t, dt, shape) in extra.items():
        if not t.is_contiguous() or t.device != p_t.device or t.dtype != dt or t.shape != shape:
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape {tuple(shape)} "
                             f"on {p_t.device}")
    if p_t.device.type == "cpu":
        launches["plain"] += 1
        return fused_linearize_plain(p_t, m_rot, query_weight, seed, targets, target_mask,
                                     target_normals, target_normals_valid, cand, counts,
                                     radius, plane_eps)
    if p_t.device.type != "cuda":
        raise ValueError(f"unsupported device {p_t.device}")
    q_total = p_t.shape[0]
    qc = q_total // TILE
    hb = torch.empty((qc, N_SLOTS), dtype=torch.float32, device=p_t.device)
    pay = torch.empty((q_total, 8), dtype=torch.float32, device=p_t.device)
    idx = torch.empty((q_total,), dtype=torch.int32, device=p_t.device)
    gap_unit = float(np.float32(float(radius) * float(radius) / _GAP_SCALE))
    with torch.cuda.device(p_t.device):
        err = cuda_build.library().dlo_fused_linearize(
            p_t.data_ptr(), m_rot.data_ptr(), query_weight.data_ptr(), seed.data_ptr(),
            targets.data_ptr(), target_mask.data_ptr(), target_normals.data_ptr(),
            target_normals_valid.data_ptr(), cand.data_ptr(), counts.data_ptr(),
            qc, cand.shape[1], f32_radius2(radius), gap_unit,
            float(np.float32(1.0 - plane_eps)),
            hb.data_ptr(), pay.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(p_t.device).cuda_stream,
        )
    cuda_build.check(err, "fused_linearize")
    launches["cuda"] += 1
    return hb, pay, idx


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
    previous-iteration correspondences that warm-start the branch-and-bound;
    the result is exactly the unseeded one.
    """
    p_t = p_t.contiguous()
    m_rot = m_rot.contiguous()
    qlo, qhi = morton.chunk_aabbs(p_t, query_weight, TILE)
    cand, counts = candidate_chunks(qlo, qhi, chunk_lo, chunk_hi, radius)
    if seed_corr is None:
        seed = torch.full(query_weight.shape, -1, dtype=torch.int32, device=p_t.device)
    else:
        seed = seed_corr.to(torch.int32).contiguous()
    hb, pay, corr = fused_linearize_pruned(
        p_t, m_rot, query_weight, seed, target_points, target_mask,
        target_normals, target_normals_valid, cand, counts, radius, plane_eps,
    )
    sums = torch.sum(hb, dim=0)
    h00, h01, h02, h11, h12, h22 = sums[0:6].unbind()
    tr = sums[6:15].reshape(3, 3)
    m00, m01, m02, m11, m12, m22 = sums[15:21].unbind()
    h_tl = torch.stack([torch.stack([h00, h01, h02]), torch.stack([h01, h11, h12]),
                        torch.stack([h02, h12, h22])])
    h_br = torch.stack([torch.stack([m00, m01, m02]), torch.stack([m01, m11, m12]),
                        torch.stack([m02, m12, m22])])
    # the kernel emits S M = -S^T M; _linearize's h_tr = -sum S^T M = +sum S M
    h = torch.cat([torch.cat([h_tl, tr], dim=1), torch.cat([tr.T, h_br], dim=1)], dim=0)
    return FusedLinearization(
        h=h, b=sums[21:27], error=sums[27], n_corr=sums[28].to(torch.int32),
        mu_b=pay[:, 0:3], n_b=pay[:, 3:6], weight=pay[:, 6], best_d2=pay[:, 7], corr=corr,
        bb_visits=sums[29], bb_candidates=sums[30],
    )
