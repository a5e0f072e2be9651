"""Exhaustive neighbour search: the ``"brute"`` backend.

Counterpart of the JAX package's ``ops/bruteforce.py`` (there XLA-lowered
``jnp`` code, no Pallas kernel), as ordinary tensor ops on the caller's
device. Distances use the difference form ``((dx*dx + dy*dy) + dz*dz)``,
in the reference's order, never the norm expansion: at world coordinates
of hundreds of metres ``|p|^2`` cancellation in f32 would cost ~0.1 m^2.

XLA fuses the JAX version's subtract/square/reduce into its tile loop; here
each step is its own operation, so both the queries and the targets are
tiled and no temporary holds more than ``MAX_ELEMS`` elements ([Q, T, 3]
is never formed). Tiling does not change a result: within a tile the first
minimum wins and across tiles a strict ``<`` keeps the earlier one, so the
winner is the first minimum over all targets, as in the JAX version.

Contracts match :mod:`direct_lidar_odometry_tpu_torch.ops.hashgrid`:
indices into the target's original order, -1 / masked where not found.

Both searches also take B lanes (targets [B, T, 3], queries [B, Q, 3], the
batched step; the JAX version under ``jax.vmap``): each lane searches its
own targets, and the query tile is cut by B, so the lanes together hold no
more than MAX_ELEMS elements in a temporary. Every operation is
elementwise, an exact minimum or a top-k over unique keys, so a lane's
result is its own call's bit for bit.
"""

from __future__ import annotations

import torch

MAX_ELEMS = 1 << 25  # elements of one [query tile, target tile] temporary (128 MiB of f32)


def _d2(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., A, 3] x [..., C, 3] -> [..., A, C] squared distances in the
    reference's order."""
    dx = q[..., :, None, 0] - t[..., None, :, 0]
    dy = q[..., :, None, 1] - t[..., None, :, 1]
    dz = q[..., :, None, 2] - t[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _lanes(queries: torch.Tensor) -> int:
    """B of [B, Q, 3] queries, 1 of [Q, 3]."""
    return queries.shape[0] if queries.dim() == 3 else 1


def k_smallest(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of a contiguous [..., W] d2 (>= 0 or
    +inf), ascending, equal values in column order (``lax.top_k``'s order):
    (d2 [..., k], column [..., k] int64). The top-k runs over int64 keys
    (d2 bits << 32 | column), which are unique, so no tie is left to the
    sort (``torch.topk`` promises no order among equal values); d2 >= 0, so
    its f32 bits order like its values."""
    col = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | col
    key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    return (key >> 32).to(torch.int32).view(torch.float32), key & 0xFFFFFFFF


def query_1nn(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    radius,
    tile: int = 8192,
):
    """Exact 1-NN within ``radius``: ([T,3],[T],[Q,3],[Q]) -> (idx, d2, found),
    or each lane's over [B, ...] inputs.

    Tiles the target axis by ``tile`` with a running (min, argmin) carry;
    the query axis is tiled so the lanes' [query tile, tile] blocks stay
    within MAX_ELEMS. ``d2`` is the raw minimum (inf when no valid target).
    """
    t_total = target_points.shape[-2]
    if t_total % tile:
        raise ValueError(f"{t_total} targets are not a multiple of tile {tile}")
    dev = queries.device
    radius2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2
    q_tile = max(1, MAX_ELEMS // (tile * _lanes(queries)))
    best_d2 = torch.full(queries.shape[:-1], torch.inf, dtype=torch.float32, device=dev)
    best_idx = torch.full(queries.shape[:-1], -1, dtype=torch.int32, device=dev)
    for q0 in range(0, queries.shape[-2], q_tile):
        q = queries[..., q0:q0 + q_tile, :]
        bd, bi = best_d2[..., q0:q0 + q_tile], best_idx[..., q0:q0 + q_tile]
        for base in range(0, t_total, tile):
            d2 = _d2(q, target_points[..., base:base + tile, :])
            d2 = torch.where(target_mask[..., None, base:base + tile], d2, torch.inf)
            tile_d2, arg = torch.min(d2, dim=-1)  # first minimum
            better = tile_d2 < bd
            bd.copy_(torch.where(better, tile_d2, bd))
            bi.copy_(torch.where(better, (arg + base).to(torch.int32), bi))
    found = query_mask & (best_d2 < radius2)
    idx = torch.where(found, best_idx, -1)
    return idx, best_d2, found


def query_knn(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int,
    chunk: int = 2048,
):
    """Exact k-NN, unbounded radius (the reference's kd-tree kNN): (idx [Q,k],
    d2 [Q,k], valid [Q,k]), nearest first, equal distances in target order
    (``lax.top_k``'s order in the JAX version); each lane's ([B, Q, k])
    over [B, ...] inputs. Queries go in chunks of ``chunk`` (the JAX
    version's shape contract), each cut further so the lanes' [rows, T]
    blocks stay within MAX_ELEMS.
    """
    q_total, t_total = queries.shape[-2], target_points.shape[-2]
    if q_total % chunk:
        raise ValueError(f"{q_total} queries are not a multiple of chunk {chunk}")
    dev = queries.device
    rows = max(1, min(chunk, MAX_ELEMS // max(t_total * _lanes(queries), 1)))
    idx = torch.empty(queries.shape[:-1] + (k,), dtype=torch.int32, device=dev)
    d2 = torch.empty(queries.shape[:-1] + (k,), dtype=torch.float32, device=dev)
    for q0 in range(0, q_total, rows):
        dd = torch.where(target_mask[..., None, :],
                         _d2(queries[..., q0:q0 + rows, :], target_points), torch.inf)
        d2[..., q0:q0 + rows, :], col = k_smallest(dd, k)
        idx[..., q0:q0 + rows, :] = col.to(torch.int32)
    valid = query_mask[..., None] & torch.isfinite(d2)
    return torch.where(valid, idx, -1), d2, valid
