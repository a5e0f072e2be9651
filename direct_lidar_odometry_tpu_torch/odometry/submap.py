"""Submap keyframe selection and assembly.

Counterpart of the JAX package's ``odometry/submap.py``, reference
``getSubmapKeyframes`` (``odom.cc:1240-1331``): the S2M target is the union
of the knn nearest keyframes, the kcv nearest convex-hull keyframes and the
kcc nearest concave-hull keyframes, with change detection so the submap
cache is rebuilt only when the member set changes. ``pushSubmapIndices``
keeps every element <= the kth smallest distance, ties included
(``odom.cc:1210-1233``).

The selection takes a leading lane dimension (the batched step, with the
device hull surrogates); :func:`assemble_submap_batched` is the batched
twin of :func:`assemble_submap`, the S2M hash grid's rows included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend, submap_flat_size
from direct_lidar_odometry_tpu_torch.core.cloud import gather_rows
from direct_lidar_odometry_tpu_torch.ops import morton
from direct_lidar_odometry_tpu_torch.odometry import hulls
from direct_lidar_odometry_tpu_torch.odometry.state import KeyframeStore, OdomState, build_submap_grid
from direct_lidar_odometry_tpu_torch.registration import gicp
from direct_lidar_odometry_tpu_torch.utils import graphs, sync
from direct_lidar_odometry_tpu_torch.utils.lanes import lanes_where


def k_smallest_members(d2: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[..., K], [..., K] -> [..., K] bool: masked elements <= the kth
    smallest masked value (all masked elements when fewer than k are
    valid)."""
    vals = torch.where(mask, d2, torch.inf)
    kk = min(k, d2.shape[-1])
    kth = torch.topk(vals, kk, largest=False).values[..., -1:]
    fallback = torch.clamp(torch.amax(torch.where(mask, vals, -torch.inf), dim=-1, keepdim=True),
                           min=0.0)
    kth = torch.where(torch.isfinite(kth), kth, fallback)
    return mask & (vals <= kth)


class SubmapSelection(NamedTuple):
    members: torch.Tensor  # [K] bool ([B, K] for B lanes)
    changed: torch.Tensor  # bool ([B])


def select_submap_keyframes(
    kf: KeyframeStore,
    prev_members: torch.Tensor,
    query_pos: torch.Tensor,
    alpha: torch.Tensor,
    cfg: DloConfig,
    directions: torch.Tensor,
    hull_masks: tuple[torch.Tensor, torch.Tensor, bool] | None = None,
) -> SubmapSelection:
    """Choose the submap keyframe set around the S2S-propagated position.

    ``hull_masks`` = (cvx [K] bool, ccv [K] bool, fresh): exact host hull
    memberships (``odometry/hosthull.py``); when fresh they replace the
    device surrogates. With B lanes (a batched ring, ``query_pos`` [B, 3],
    ``alpha`` [B]) each lane selects from its own ring, through the
    surrogates.
    """
    k = kf.capacity
    kmask = torch.arange(k, device=kf.count.device) < kf.count[..., None]
    diff = kf.positions - query_pos[..., None, :]
    d2 = torch.sum(diff * diff, dim=-1)

    knn_sel = k_smallest_members(d2, kmask, cfg.submap.knn)
    if hull_masks is not None and hull_masks[2]:
        cvx = hull_masks[0] & kmask
        ccv = hull_masks[1] & kmask
    else:
        cvx = hulls.convex_membership(kf.positions, kmask, directions)
        ccv = hulls.concave_membership(kf.positions, kmask, directions, alpha)
    cvx_sel = k_smallest_members(d2, cvx, cfg.submap.kcv)
    ccv_sel = k_smallest_members(d2, ccv, cfg.submap.kcc)

    members = (knn_sel | cvx_sel | ccv_sel) & kmask
    # cap at max_submap_kf members, keeping the nearest; exact distance ties
    # can overflow k_smallest's bound, so enforce the hard cap by rank
    members = k_smallest_members(d2, members, cfg.shapes.max_submap_kf)
    idx_rank = torch.cumsum(members.to(torch.int32), dim=-1) - 1
    members = members & (idx_rank < cfg.shapes.max_submap_kf)
    changed = torch.any(members != prev_members, dim=-1)
    return SubmapSelection(members=members, changed=changed)


def _assemble(kf: KeyframeStore, members: torch.Tensor, query_pos: torch.Tensor,
              cache: tuple, cfg: DloConfig, backend: str) -> tuple:
    """The submap of ``members`` written IN PLACE into ``cache`` (points,
    mask, normals, normals valid); returns nothing."""
    s_max = cfg.shapes.max_submap_kf
    nk = cfg.shapes.n_keyframe
    flat_out = submap_flat_size(cfg)
    k = kf.capacity
    ar = torch.arange(k, device=members.device)
    # member keyframe indices, ascending, packed into s_max slots
    order = torch.argsort(torch.where(members, ar, k + ar))[:s_max]
    slot_valid = members[order]
    pts = kf.points[order].reshape(s_max * nk, 3)
    msk = (kf.masks[order] & slot_valid[:, None]).reshape(s_max * nk)
    nrm = kf.normals[order].reshape(s_max * nk, 3)
    nvl = (kf.normals_valid[order] & slot_valid[:, None]).reshape(s_max * nk)
    if flat_out < s_max * nk:
        d2 = torch.sum((pts - query_pos) ** 2, dim=-1)
        d2 = torch.where(msk, d2, torch.inf)
        keep = torch.sort(d2, stable=True).indices[:flat_out]
        pts, msk, nrm, nvl = pts[keep], msk[keep], nrm[keep], nvl[keep]
    if gicp.is_pallas(backend):
        z = morton.sort_order(pts, msk)
        pts, msk, nrm, nvl = pts[z], msk[z], nrm[z], nvl[z]
    for buf, new in zip(cache, (pts, msk, nrm, nvl)):
        buf.copy_(new)
    return ()


def assemble_submap(
    state: OdomState,
    sel: SubmapSelection,
    query_pos: torch.Tensor,
    cfg: DloConfig,
    backend: str | None = None,
    run=graphs.eager,
) -> tuple[OdomState, bool]:
    """Rebuild the submap cache IN PLACE iff the member set changed.

    Reference ``odom.cc:1309-1329``: concatenate the member keyframe clouds
    and cached normals; beyond ``shapes.n_submap_flat`` points keep those
    nearest ``query_pos``; on the pruned-kernel backends Z-order the result
    for the pruned S2M search; on "hashgrid" rebuild the S2M hash index
    (the index build the reference hides in ``gicp.setInputTarget``,
    ``odom.cc:828``). One host read (``changed``) replaces the JAX
    package's ``lax.cond``; the rebuild is a stretch of ``run``
    (``utils/graphs.py``; run eagerly by default). Returns (state,
    changed).
    """
    backend = backend or resolve_backend(cfg)
    changed = bool(sync.read(sel.changed))
    if changed:
        cache = (state.submap_points, state.submap_mask, state.submap_normals,
                 state.submap_normals_valid)
        run(_assemble, state.keyframes, sel.members, query_pos, cache, cfg, backend)
        if backend == "hashgrid":
            state = state._replace(
                submap_grid=build_submap_grid(cfg, state.submap_points, state.submap_mask))
    return state._replace(submap_members=sel.members), changed


def assemble_submap_batched(
    state: OdomState,
    sel: SubmapSelection,
    query_pos: torch.Tensor,
    cfg: DloConfig,
    backend: str | None = None,
) -> tuple[OdomState, torch.Tensor]:
    """:func:`assemble_submap` over B lanes (a batched state, ``sel`` of
    [B, K] members, ``query_pos`` [B, 3]); every backend.

    One host read of the [B] change flags replaces the JAX package's
    ``lax.cond`` under ``vmap``: no lane changed, nothing runs; else the
    changed lanes are gathered, their submaps assembled together and
    written IN PLACE into their rows of the cache, and on "hashgrid" their
    S2M grids built together and written into their rows of every grid
    leaf. Returns (state, changed [B] bool tensor).
    """
    backend = backend or resolve_backend(cfg)
    n = sum(sync.read(sel.changed))
    if n:
        lanes = lanes_where(sel.changed, n)
        s_max = cfg.shapes.max_submap_kf
        nk = cfg.shapes.n_keyframe
        flat_out = submap_flat_size(cfg)
        kf = state.keyframes
        k = kf.capacity
        members = sel.members[lanes]                                     # [n, K]
        ar = torch.arange(k, device=members.device)
        # each lane's member keyframe indices, ascending, packed into s_max slots
        order = torch.argsort(torch.where(members, ar, k + ar), dim=-1)[:, :s_max]
        slot_valid = torch.gather(members, 1, order)[..., None]
        rows = (lanes[:, None], order)
        pts = kf.points[rows].reshape(n, s_max * nk, 3)
        msk = (kf.masks[rows] & slot_valid).reshape(n, s_max * nk)
        nrm = kf.normals[rows].reshape(n, s_max * nk, 3)
        nvl = (kf.normals_valid[rows] & slot_valid).reshape(n, s_max * nk)
        if flat_out < s_max * nk:
            d2 = torch.sum((pts - query_pos[lanes][:, None, :]) ** 2, dim=-1)
            d2 = torch.where(msk, d2, torch.inf)
            keep = torch.sort(d2, dim=-1, stable=True).indices[:, :flat_out]
            pts, msk, nrm, nvl = (gather_rows(a, keep) for a in (pts, msk, nrm, nvl))
        if gicp.is_pallas(backend):
            z = morton.sort_order(pts, msk)
            pts, msk, nrm, nvl = (gather_rows(a, z) for a in (pts, msk, nrm, nvl))
        state.submap_points.index_copy_(0, lanes, pts)
        state.submap_mask.index_copy_(0, lanes, msk)
        state.submap_normals.index_copy_(0, lanes, nrm)
        state.submap_normals_valid.index_copy_(0, lanes, nvl)
        if backend == "hashgrid":
            for leaf, new in zip(state.submap_grid, build_submap_grid(cfg, pts, msk)):
                leaf.index_copy_(0, lanes, new)
    return state._replace(submap_members=sel.members), sel.changed
