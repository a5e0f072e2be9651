"""Loop closure and map refinement, a capability the reference lacks.

Counterpart of the JAX package's ``odometry/loopclosure.py`` (SURVEY.md §5:
the reference never revisits its keyframes, so drift grows unbounded):

1. :func:`loop_candidates`: keyframe pairs whose poses are close but whose
   insertion ranks are far apart, the top ``max_loops`` by distance over
   the [K, K] distance matrix;
2. :func:`register_loop_edges`: GICP between the stored world-frame
   keyframe clouds (normals are cached in the ring) from an identity guess,
   through the backend's search (kernel K2, K3 or K4, or the exhaustive or
   hash-grid tensor op on "brute" / "hashgrid"). The measured
   relative pose is ``Z_ij = X_i^-1 dT X_j`` where ``dT`` aligns cloud j
   onto cloud i. Edges that fail to converge or match too few points get
   weight 0 (shapes stay static);
3. :func:`refine_and_reanchor`: the health-weighted odometry chain plus
   the loop edges feed the dense Gauss-Newton of ``parallel/posegraph.py``;
   every keyframe cloud, its normals, the current pose and the S2S basis
   are re-anchored by the per-keyframe correction, and the cached submap is
   invalidated so the next frame rebuilds it from the refined ring.

The JAX package's ``lax.map`` over the edges and ``lax.cond`` on the
accepted count are host loops and a host ``if`` here. The keyframe ring is
written in place (``state.py``); :func:`reanchor` reads everything it needs
from the old poses before it writes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.odometry.state import KeyframeStore, OdomState
from direct_lidar_odometry_tpu_torch.parallel import posegraph
from direct_lidar_odometry_tpu_torch.registration import gicp
from direct_lidar_odometry_tpu_torch.utils import sync


class LoopEdges(NamedTuple):
    edges: torch.Tensor     # [L, 2] int (i, j), i earlier than j
    mask: torch.Tensor      # [L] bool candidate validity
    rel: torch.Tensor       # [L, 4, 4] measured Z_ij (identity when rejected)
    weight: torch.Tensor    # [L] information weight (0 when rejected)
    num_corr: torch.Tensor  # [L] int32 GICP correspondences (diagnostics)


class RefineInfo(NamedTuple):
    n_candidates: int             # loop candidates found
    n_accepted: int               # loop edges that passed the GICP gate
    graph_error: torch.Tensor     # f32 graph residual of the last GN linearization
    max_correction: torch.Tensor  # f32 largest keyframe translation correction


def _slot_poses(store: KeyframeStore) -> torch.Tensor:
    return se3.make_se3(se3.quat_to_rotmat(store.quats), store.positions)


def loop_candidates(
    store: KeyframeStore, loop_radius: float, min_index_gap: int,
    max_loops: int, min_seq_gap: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``max_loops`` closest eligible (i, j) keyframe pairs: both slots
    occupied, insertion-RANK separation >= ``min_index_gap`` (ranks from
    ``KeyframeStore.seq``, so eviction-rewritten slots cannot fake a gap),
    spawn-FRAME separation >= ``min_seq_gap``, pose distance <
    ``loop_radius``. Returns ([L, 2] edges, [L] bool mask); the order among
    the masked-out entries is unspecified."""
    k = store.capacity
    dev = store.positions.device
    pos = store.positions
    valid = torch.arange(k, device=dev) < store.count
    # rank of each slot in trajectory (insertion) order
    order = torch.argsort(torch.where(valid, store.seq, 2**30), stable=True)
    rank = torch.empty((k,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(k, device=dev)
    diff = pos[:, None, :] - pos[None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [K, K]
    gap = torch.abs(rank[None, :] - rank[:, None])
    seq_gap = torch.abs(store.seq[None, :] - store.seq[:, None])
    # i = the EARLIER keyframe of the pair (rank order), j = the later
    ok = (
        valid[:, None] & valid[None, :]
        & (rank[None, :] > rank[:, None])
        & (gap >= min_index_gap)
        & (seq_gap >= min_seq_gap)
        & (d < loop_radius)
    )
    flat_d = torch.where(ok, d, torch.inf).reshape(-1)
    idx = torch.topk(-flat_d, max_loops).indices
    edges = torch.stack([idx // k, idx % k], dim=1)
    return edges, torch.isfinite(flat_d[idx])


def register_loop_edges(
    store: KeyframeStore, edges: torch.Tensor, mask: torch.Tensor,
    cfg: DloConfig, backend: str,
) -> LoopEdges:
    """Measure loop constraints by cloud-to-cloud GICP.

    Keyframe clouds are stored in the WORLD frame, so aligning cloud j
    (source) onto cloud i (target) from an identity guess gives the
    world-frame drift correction ``dT``. The stage is S2M's with the WIDE
    loop gate ``posegraph.loop_corr_distance`` and ``loop_max_iterations``:
    the identity guess must swallow the drift accumulated between the two
    visits. One host read fetches the candidate list; a masked-out edge
    skips ``align`` (its outputs are fixed: identity, weight 0, 0
    correspondences).
    """
    dev = store.positions.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    stage = dataclasses.replace(
        cfg.gicp.s2m,
        max_correspondence_distance=cfg.posegraph.loop_corr_distance,
        max_iterations=cfg.posegraph.loop_max_iterations,
    )
    pairs = sync.read(torch.cat([edges, mask[:, None].to(edges.dtype)], dim=1))
    rel, weight, num_corr = [], [], []
    x = _slot_poses(store)
    zero_w = torch.zeros((), dtype=torch.float32, device=dev)
    zero_nc = torch.zeros((), dtype=torch.int32, device=dev)
    for i, j, on in pairs:
        if not on:
            rel.append(eye)
            weight.append(zero_w)
            num_corr.append(zero_nc)
            continue
        target = gicp.make_target(store.points[i], store.masks[i],
                                  store.normals[i], store.normals_valid[i],
                                  stage.max_correspondence_distance,
                                  cfg.shapes.submap_table_size, backend)
        src = gicp.GicpSource(points=store.points[j], mask=store.masks[j],
                              normals=store.normals[j], normals_valid=store.normals_valid[j])
        res = gicp.align(src, target, eye, stage, backend, cfg.shapes.cell_cap_1nn)
        z = se3.se3_inverse(x[i]) @ (res.transform @ x[j])
        good = (res.num_correspondences >= cfg.posegraph.min_loop_corr) & (
            res.converged and not res.lm_failed)
        rel.append(torch.where(good, z, eye))
        weight.append(torch.where(good, cfg.posegraph.loop_weight, zero_w))
        num_corr.append(res.num_correspondences.to(torch.int32))
    return LoopEdges(edges=edges, mask=mask, rel=torch.stack(rel),
                     weight=torch.stack(weight),
                     num_corr=torch.stack(num_corr))


def build_refinement_graph(
    store: KeyframeStore, loops: LoopEdges, chain_weight: float,
) -> posegraph.PoseGraph:
    """Chain prior (current estimates) + measured loop edges.

    Chain edges start at zero residual; loop edges carry the new
    information and GN redistributes their correction along the chain.
    Chain edges are weighted by the endpoints' spawn-time odometry health
    (``KeyframeStore.health``): an edge through a degraded stretch gets
    ``(median_health / edge_health)^2``, so the correction concentrates
    where the drift arose instead of dragging accurate keyframes off.
    """
    chain = posegraph.odometry_chain_graph(
        store.positions, store.quats, store.count, seq=store.seq
    )
    k = store.capacity
    valid = torch.arange(k, device=store.positions.device) < store.count
    # median spawn health over the valid keyframes = the "healthy" reference
    h_sorted = torch.sort(torch.where(valid, store.health, torch.inf)).values
    med = h_sorted[torch.clamp(store.count - 1, min=0) // 2]
    med = torch.clamp(med, min=1e-6)
    h_edge = torch.maximum(store.health[chain.edges[:, 0]], store.health[chain.edges[:, 1]])
    info = (med / torch.maximum(h_edge, med)) ** 2  # in (0, 1], 1 = healthy
    return posegraph.PoseGraph(
        poses=chain.poses,
        pose_mask=chain.pose_mask,
        edges=torch.cat([chain.edges, loops.edges.to(chain.edges.dtype)], dim=0),
        rel=torch.cat([chain.rel, loops.rel], dim=0),
        edge_mask=torch.cat([chain.edge_mask, loops.weight > 0], dim=0),
        weights=torch.cat([chain.weights * chain_weight * info, loops.weight], dim=0),
    )


def reanchor(state: OdomState, new_poses: torch.Tensor) -> tuple[OdomState, torch.Tensor]:
    """Apply refined keyframe poses to every world-frame artifact.

    The per-keyframe correction ``dT_k = X_k_new X_k_old^-1`` moves the
    stored points (masked-in rows only: pad rows stay at ``PAD_VALUE``,
    where the JAX package moves them too) and rotates the cached normals,
    in place. The current pose and the S2S basis are re-anchored by the
    correction of the keyframe nearest the current position, found among
    the OLD positions. The previous scan (S2S target) is in the sensor
    frame and stays. The cached submap's members are cleared, so the next
    frame rebuilds it from the refined ring.
    """
    store = state.keyframes
    k = store.capacity
    dev = store.positions.device
    valid = torch.arange(k, device=dev) < store.count
    # every read of the old ring happens before the in-place writes below
    delta = new_poses @ se3.se3_inverse(_slot_poses(store))
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    delta = torch.where(valid[:, None, None], delta, eye)  # freeze unused slots
    r = delta[:, :3, :3]
    t = delta[:, :3, 3]
    cur = se3.se3_translation(state.pose)
    d2 = torch.sum((store.positions - cur) ** 2, dim=-1)
    d_anchor = delta[torch.argmin(torch.where(valid, d2, torch.inf))]
    max_corr = torch.max(torch.where(valid, torch.linalg.norm(t, dim=-1), 0.0))
    new_pos = torch.where(valid[:, None], new_poses[:, :3, 3], store.positions)
    new_quat = torch.where(valid[:, None], se3.rotmat_to_quat(new_poses[:, :3, :3]), store.quats)

    moved = torch.einsum("kab,knb->kna", r, store.points) + t[:, None, :]
    store.points.copy_(torch.where(store.masks[..., None], moved, store.points))
    store.normals.copy_(torch.einsum("kab,knb->kna", r, store.normals))
    store.positions.copy_(new_pos)
    store.quats.copy_(new_quat)
    new_state = state._replace(
        pose=d_anchor @ state.pose,
        t_s2s=d_anchor @ state.t_s2s,
        submap_members=torch.zeros_like(state.submap_members),
    )
    return new_state, max_corr


def refine_and_reanchor(
    state: OdomState, cfg: DloConfig, backend: str,
) -> tuple[OdomState, RefineInfo]:
    """One loop-closure round: detect -> register -> refine -> re-anchor.
    When no loop edge passes the GICP gate the state is returned as it was
    (chain edges alone have zero residual at the current estimates).

    Each stage is a span of ``utils/sync.py``: ``refine.candidates``,
    ``refine.register`` (the loop edges' aligns count their iterations as
    ``align_iters.refine.register``; the read of the candidate and accepted
    counts is its wait), ``refine.solve`` and ``refine.reanchor`` (host
    time: the re-anchoring's device work drains in the caller's next
    read). Counters: ``refine.rounds``, ``refine.edges_registered``,
    ``refine.edges_accepted`` and ``refine.live_keyframes`` (the ring's
    count at each solve)."""
    pg = cfg.posegraph
    store = state.keyframes
    sync.count("refine.rounds")
    with sync.span("refine.candidates"):
        edges, cand_mask = loop_candidates(
            store, pg.loop_radius, pg.min_index_gap, pg.max_loops, min_seq_gap=pg.min_seq_gap,
        )
    with sync.span("refine.register"):
        loops = register_loop_edges(store, edges, cand_mask, cfg, backend)
        n_candidates, n_accepted, n_live = sync.read(torch.stack(
            [cand_mask.sum(), (loops.weight > 0).sum(), store.count.long()]))
    sync.count("refine.edges_registered", n_candidates)
    sync.count("refine.edges_accepted", n_accepted)
    err = max_corr = torch.zeros((), dtype=torch.float32, device=edges.device)
    if n_accepted > 0:
        sync.count("refine.live_keyframes", n_live)
        with sync.span("refine.solve"):
            graph = build_refinement_graph(store, loops, pg.chain_weight)
            new_poses, err = posegraph.refine(graph, iterations=pg.iterations)
        with sync.span("refine.reanchor"):
            state, max_corr = reanchor(state, new_poses)
    return state, RefineInfo(n_candidates=n_candidates, n_accepted=n_accepted,
                             graph_error=err, max_correction=max_corr)
