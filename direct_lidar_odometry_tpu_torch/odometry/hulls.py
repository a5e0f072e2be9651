"""Keyframe hull membership — device-side surrogates for QHull.

Counterpart of the JAX package's ``odometry/hulls.py`` (reference
``odom.cc:1017-1090``). The runner prefers exact host hulls
(``odometry/hosthull.py``); these surrogates serve the frames where no
fresh host mask exists yet:

- convex: a keyframe is a hull vertex iff it is the argmax along some of
  D fixed directions (equatorial ring + Fibonacci sphere);
- concave (alpha shape): a keyframe is on the boundary iff along some
  direction no neighbour within 2*alpha lies further out.

Both take a leading lane dimension ([B, K, 3] rings, [B] alphas) for the
batched step, which always uses these surrogates (as the JAX package's
batched and sharded paths do).
"""

from __future__ import annotations

import numpy as np
import torch


def fibonacci_directions(d: int) -> np.ndarray:
    """D scan directions: an equatorial ring (60%) plus a Fibonacci sphere
    (40%); near-planar keyframe sets have their hull rims near the
    horizontal plane."""
    n_ring = int(d * 0.6)
    n_sph = d - n_ring
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    ring = np.stack([np.cos(th), np.sin(th), 0.05 * np.sin(3 * th)], axis=1)
    ring /= np.linalg.norm(ring, axis=1, keepdims=True)
    i = np.arange(n_sph, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / max(n_sph, 1))
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    sph = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    )
    return np.concatenate([ring, sph]).astype(np.float32)


def convex_membership(
    positions: torch.Tensor, mask: torch.Tensor, directions: torch.Tensor
) -> torch.Tensor:
    """[..., K, 3], [..., K], [D, 3] -> [..., K] bool; fewer than 4
    keyframes -> none."""
    proj = positions @ directions.T  # [..., K, D]
    proj = torch.where(mask[..., None], proj, -torch.inf)
    best = torch.argmax(proj, dim=-2)  # [..., D]
    members = torch.zeros(mask.shape, dtype=torch.bool, device=positions.device)
    if best.dim() == 1:
        members[best] = True
    else:
        members.scatter_(-1, best, True)
    enough = torch.sum(mask, dim=-1, keepdim=True) >= 4
    return members & mask & enough


def concave_membership(
    positions: torch.Tensor,
    mask: torch.Tensor,
    directions: torch.Tensor,
    alpha: torch.Tensor,
) -> torch.Tensor:
    """[..., K,3], [..., K], [D,3], [...] -> [..., K] bool; fewer than 5
    keyframes -> none."""
    k = positions.shape[-2]
    diff = positions[..., None, :, :] - positions[..., :, None, :]  # [..., K, K, 3] j - i
    d2 = torch.sum(diff * diff, dim=-1)
    radius2 = ((2.0 * alpha) ** 2)[..., None, None]
    near = (d2 <= radius2) & mask[..., None, :] & mask[..., :, None]
    near = near & ~torch.eye(k, dtype=torch.bool, device=positions.device)
    along = torch.einsum("...ijc,dc->...ijd", diff, directions)  # [..., K, K, D]
    margin = (1e-3 * alpha)[..., None, None, None]
    blocked = torch.any(near[..., None] & (along > margin), dim=-2)  # [..., K, D]
    boundary = torch.any(~blocked, dim=-1) & mask
    enough = torch.sum(mask, dim=-1, keepdim=True) >= 5
    return boundary & enough
