"""Keyframe pose-graph refinement: dense Gauss-Newton on SE(3)^K.

Counterpart of the JAX package's ``parallel/posegraph.py`` (a capability
the reference lacks, SURVEY.md §5): refine the keyframe poses given
relative-pose constraints, the odometry chain and any loop-closure edges.

- residuals ``e_ij = log(Z_ij^-1 X_i^-1 X_j)`` batched over the [M] edges,
  with ANALYTIC first-order Jacobians of the pseudo-exponential retraction
  the GICP solver uses (``core/se3.se3_exp``): right-perturbing
  ``X_j <- X_j P(xi)`` gives ``J_j = [[Jr^-1(w), 0], [0, R_E]]`` and
  perturbing ``X_i`` gives
  ``J_i = [[-Jr^-1(w) R_A^T, 0], [R_Z^T skew(t_A), -R_Z^T]]`` with
  ``A = X_i^-1 X_j``, ``E = Z^-1 A``, ``w = log(R_E)``,
  ``Jr^-1(w) ~ I + skew(w)/2``. Analytic rather than autograd because
  ``so3_log``'s arccos has an unbounded derivative at a zero residual,
  where every chain edge starts;
- the normal system is dense, H is [6K, 6K], assembled from the per-edge
  6x6 blocks into a [K, K, 6, 6] view through the edges' incidence
  matrices (matrix products, so the sums are deterministic on the card);
- the gauge is fixed by pinning pose 0 with a strong prior; the system is
  Jacobi-equilibrated before the float32 solve;
- distributed (the JAX package's ``axis_name`` form): with a
  ``torch.distributed`` process group each rank holds a shard of the
  edges, and every iteration sums H, b and the error over the group
  (``all_reduce``, SUM) before the solve, which every rank repeats on the
  same sums (``parallel/sharded.py`` ``make_distributed_refine``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # [K, 4, 4] current estimates
    pose_mask: torch.Tensor   # [K] valid poses
    edges: torch.Tensor       # [M, 2] int (i, j)
    rel: torch.Tensor         # [M, 4, 4] measured Z_ij (i -> j)
    edge_mask: torch.Tensor   # [M]
    weights: torch.Tensor     # [M] scalar information weight


def residual(poses: torch.Tensor, edges: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """[rot, trans] residuals of the edges: [K,4,4], [M,2], [M,4,4] -> [M,6]."""
    t_ij = se3.se3_inverse(poses[edges[..., 0]]) @ poses[edges[..., 1]]
    err = se3.se3_inverse(z) @ t_ij
    return torch.cat([se3.so3_log(err[..., :3, :3]), err[..., :3, 3]], dim=-1)


def edge_jacobians(x_i: torch.Tensor, x_j: torch.Tensor, z: torch.Tensor):
    """Residual and first-order Jacobians wrt right perturbations, batched
    over leading dimensions: (r [..., 6], J_i [..., 6, 6], J_j [..., 6, 6]).
    Derivation in the module docstring."""
    a = se3.se3_inverse(x_i) @ x_j          # A = X_i^-1 X_j
    err = se3.se3_inverse(z) @ a            # E = Z^-1 A
    r_e = err[..., :3, :3]
    w = se3.so3_log(r_e)
    r = torch.cat([w, err[..., :3, 3]], dim=-1)

    jr_inv = torch.eye(3, dtype=torch.float32, device=w.device) + 0.5 * se3.skew(w)
    r_a = a[..., :3, :3]
    r_zt = z[..., :3, :3].transpose(-1, -2)
    zero = torch.zeros_like(jr_inv)
    j_j = torch.cat([torch.cat([jr_inv, zero], dim=-1), torch.cat([zero, r_e], dim=-1)], dim=-2)
    j_i = torch.cat([
        torch.cat([-jr_inv @ r_a.transpose(-1, -2), zero], dim=-1),
        torch.cat([r_zt @ se3.skew(a[..., :3, 3]), -r_zt], dim=-1),
    ], dim=-2)
    return r, j_i, j_j


def build_normal_system(graph: PoseGraph) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense H [6K, 6K], b [6K] and the weighted squared error.

    The edges' blocks are summed through the [M, K] incidence matrices of
    their i and j ends, as float32 matrix products, not scattered: a
    scatter on the card adds a keyframe's repeated blocks with atomics in
    whatever order they land, while a product adds them in an order fixed
    by its shapes, so two builds of one graph give the same bits."""
    k = graph.poses.shape[0]
    w = graph.weights * graph.edge_mask.to(torch.float32)
    i_idx, j_idx = graph.edges[:, 0], graph.edges[:, 1]
    m = i_idx.shape[0]
    r, j_i, j_j = edge_jacobians(graph.poses[i_idx], graph.poses[j_idx], graph.rel)
    wm = w[:, None, None]
    j_it, j_jt = j_i.transpose(-1, -2), j_j.transpose(-1, -2)
    h_ii = (wm * (j_it @ j_i)).reshape(m, 36)
    h_jj = (wm * (j_jt @ j_j)).reshape(m, 36)
    h_ij = (wm * (j_it @ j_j)).reshape(m, 1, 36)
    b_i = w[:, None] * (j_it @ r[..., None])[..., 0]
    b_j = w[:, None] * (j_jt @ r[..., None])[..., 0]

    slots = torch.arange(k, device=r.device)
    inc_i = (i_idx[:, None] == slots).to(torch.float32)
    inc_j = (j_idx[:, None] == slots).to(torch.float32)
    # off-diagonal blocks H[i, j] += h_ij and their transposes H[j, i]
    off = (inc_i.T @ (inc_j[:, :, None] * h_ij).reshape(m, k * 36)).reshape(k, k, 6, 6)
    h = off + off.permute(1, 0, 3, 2)
    h[slots, slots] += (inc_i.T @ h_ii + inc_j.T @ h_jj).reshape(k, 6, 6)
    b = inc_i.T @ b_i + inc_j.T @ b_j
    err = torch.sum(w * torch.sum(r * r, dim=-1))
    h = h.permute(0, 2, 1, 3).reshape(k * 6, k * 6)
    return h, b.reshape(k * 6), err


def apply_update(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative update X_i <- X_i exp(d_i). [K,4,4], [K*6]."""
    return poses @ se3.se3_exp(delta.reshape(-1, 6))


def refine(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-4,
    prior_weight: float = 1e6,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton refinement; returns (poses, error of the last
    linearization). The iterations loop on the host; each solves the dense
    system with ``torch.linalg.solve`` (a singular H raises: with the gauge
    pin and the damping it cannot be singular unless a pose is not finite).

    ``group``: a ``torch.distributed`` process group over which the edges
    are sharded (this rank's edges in ``graph``, the poses replicated):
    H, b and the error are summed over the group (``all_reduce``, SUM)
    before the replicated solve, as the JAX package ``psum``s them. None
    (the default) refines the graph as it is, with no collective."""
    pin_float32()
    k = graph.poses.shape[0]
    dev = graph.poses.device
    pose_active = graph.pose_mask.repeat_interleave(6).to(torch.float32)
    pin = torch.zeros((k * 6,), dtype=torch.float32, device=dev)
    pin[:6] = prior_weight
    # gauge prior on pose 0 + damping + freeze invalid poses
    diag = damping + pin + torch.where(pose_active > 0, 0.0, 1e9)
    poses = graph.poses
    err = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iterations):
        h, b, err = build_normal_system(graph._replace(poses=poses))
        if group is not None:
            for t in (h, b, err):
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        h = h + torch.diag(diag)
        # Jacobi (symmetric diagonal) equilibration before the f32 solve:
        # the raw system spans the 1e6 gauge pin to the 1e-4 damping floor,
        # and an unequilibrated f32 solve returns steps with enough error
        # that GN slides off ground truth (the JAX package measured poses
        # walking 0.3 -> 0.5 m away on a 100-keyframe loop graph)
        s = torch.rsqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h * s[:, None] * s[None, :]
        delta = torch.linalg.solve(hs, -(b * s)) * s  # descend the gradient
        poses = apply_update(poses, delta * pose_active)
    return poses, err


def odometry_chain_graph(
    positions: torch.Tensor,
    quats: torch.Tensor,
    count: torch.Tensor,
    max_edges: int | None = None,
    seq: torch.Tensor | None = None,
) -> PoseGraph:
    """Chain pose graph over a keyframe store's poses: consecutive keyframes
    get a relative constraint from the current estimates (zero residual at
    the start; informative once loop edges are added).

    ``seq``: per-slot insertion sequence numbers (``KeyframeStore.seq``).
    When given, the chain follows TRAJECTORY order: after ring eviction
    rewrites slots, slot order no longer is trajectory order.
    """
    k = positions.shape[0]
    m = max_edges or (k - 1)
    dev = positions.device
    poses = se3.make_se3(se3.quat_to_rotmat(quats), positions)
    valid = torch.arange(k, device=dev) < count
    if seq is not None:
        # slots sorted by insertion id, invalid slots last
        order = torch.argsort(torch.where(valid, seq, 2**30), stable=True)
    else:
        order = torch.arange(k, device=dev)
    idx = torch.arange(m, device=dev)
    edges = torch.stack([order[idx.clamp(0, k - 1)], order[(idx + 1).clamp(0, k - 1)]], dim=1)
    rel = se3.se3_inverse(poses[edges[:, 0]]) @ poses[edges[:, 1]]
    return PoseGraph(
        poses=poses,
        pose_mask=valid,
        edges=edges,
        rel=rel,
        edge_mask=(idx + 1) < count,
        weights=torch.ones((m,), dtype=torch.float32, device=dev),
    )
