"""Spatial hash-grid neighbour search: the ``"hashgrid"`` backend.

Counterpart of the JAX package's ``ops/hashgrid.py`` (there XLA-lowered
``jnp`` code, no Pallas kernel), as ordinary tensor ops on the caller's
device. It replaces the reference's kd-tree (``nanoflann_impl.hpp``) with a
sorted cell-hash index:

- quantize points to cells of size equal to the search radius;
- hash the cell coordinates (additive prime combine + Murmur3 finalizer)
  into a table of H slots;
- sort the points by slot (stable); per-slot [start, count) ranges;
- a query gathers up to ``cap`` candidates from each of its 27 neighbour
  cells, tells cells sharing a slot apart by a second full-width cell key,
  and reduces the distances under masks.

Every neighbour within the radius lies in one of the 27 cells, so the only
approximation is the per-slot cap, whose truncation is deterministic
(lowest sorted index wins).

The JAX version hashes in uint32 and int32 with wrap-around. Here the same
values are held in int64 and reduced mod 2^32 after every product
(``ops/voxel.py`` ``_mul32``), so ``build`` gives the JAX leaves bit for
bit: ``start``, ``count``, ``src_index`` and ``key2``. Cell coordinates
divide by a 0-d tensor on the points' device (a true division; a Python
scalar divisor would become a product with its reciprocal on CUDA).

Every function also takes B lanes (points [B, N, 3], the batched step; the
JAX version under ``jax.vmap``): a batched :class:`HashGrid` has a leading
[B] on every leaf, ``cell_size`` included, as the JAX package's
``batched_state`` broadcasts it. ``build`` sorts each lane's row and
scatters its ranges into the lane's own table row; queries gather from
their lane's grid. All of it is integer work, elementwise float work or an
exact minimum, so a lane's leaves and results are its own call's bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE, gather_rows
from direct_lidar_odometry_tpu_torch.ops.bruteforce import k_smallest
from direct_lidar_odometry_tpu_torch.ops.voxel import _mul32

_P1, _P2, _P3 = 73856093, 19349669, 83492791  # spatial hash primes (Teschner et al.)
_MASK32 = 0xFFFFFFFF

_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


class HashGrid(NamedTuple):
    """Sorted-by-hash point index; ``table_size`` is fixed by the shapes
    config. B lanes' grids carry a leading [B] on every leaf."""

    points: torch.Tensor     # [N, 3] f32, in hash order, invalid slots at PAD_VALUE
    src_index: torch.Tensor  # [N] int32, original index of each sorted point
    mask: torch.Tensor       # [N] bool, sorted validity
    key2: torch.Tensor       # [N] int32 full-width cell key (tells cells sharing a slot apart)
    start: torch.Tensor      # [H] int32, first sorted position of each slot (N if empty)
    count: torch.Tensor      # [H] int32, points in each slot
    cell_size: torch.Tensor  # [] f32

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def table_size(self) -> int:
        return self.start.shape[-1]


def _take(grid: HashGrid, leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``leaf[idx]`` of one grid; of B lanes' grid (a [B] ``cell_size``)
    each lane's rows, ``leaf[b, idx[b]]``."""
    if not grid.cell_size.dim():
        return leaf[idx]
    lane = torch.arange(leaf.shape[0], device=leaf.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return leaf[lane, idx]


def _cell_coords(points: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    """[..., 3] f32 -> [..., 3] int64 holding the JAX version's int32 cells;
    a [B] ``cell_size`` divides lane b's [B, ..., 3] points by its own."""
    if cell_size.dim():
        cell_size = cell_size.reshape(cell_size.shape + (1,) * (points.dim() - 1))
    return torch.floor(points / cell_size).to(torch.int32).to(torch.int64)


def _cell_base(coords: torch.Tensor) -> torch.Tensor:
    """Additive-combined cell key, as uint32 bits (the JAX version wraps in
    int32; additive, not XOR, so symmetric offsets never collide)."""
    return (coords[..., 0] * _P1 + coords[..., 1] * _P2 + coords[..., 2] * _P3) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer, a bijective uint32 mixer (values in [0, 2^32))."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_cells(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """[..., 3] cells -> table slot in [0, table_size) (int64)."""
    return _fmix32(_cell_base(coords)) & (table_size - 1)


def _hash2_cells(coords: torch.Tensor) -> torch.Tensor:
    """Full-width cell identity key as int32 (the uint32 bits reinterpreted)."""
    m = _fmix32(_cell_base(coords) ^ 0x9E3779B9)
    return torch.where(m >= 2**31, m - 2**32, m).to(torch.int32)


def build(points: torch.Tensor, mask: torch.Tensor, cell_size, table_size: int) -> HashGrid:
    """Build the grid over [N, 3] points: one stable sort by slot, then the
    slot ranges by a scatter-min of positions and a count; invalid points
    take the out-of-range slot ``table_size``, sort last and are dropped.
    Over [B, N, 3] points, each lane's grid (``cell_size`` a scalar or
    [B]): the sort runs along each lane's row and lane b's ranges go to
    flat slots ``b * (table_size + 1) + slot``."""
    n = points.shape[-2]
    lead = points.shape[:-2]
    dev = points.device
    cell = torch.as_tensor(cell_size, dtype=torch.float32).to(dev)
    if lead:
        cell = cell.expand(lead).contiguous()
    coords = _cell_coords(points, cell)
    h = torch.where(mask, _hash_cells(coords, table_size), table_size)
    sh, order = torch.sort(h, stable=True)
    smask = gather_rows(mask, order)
    spts = torch.where(smask[..., None], gather_rows(points, order), PAD_VALUE)
    slots = table_size + 1
    lanes = lead[0] if lead else 1
    pos = torch.arange(n, device=dev)
    if lead:
        sh = (sh + slots * torch.arange(lanes, device=dev)[:, None]).reshape(-1)
        pos = pos.expand(lanes, n).reshape(-1)
    start = torch.full((lanes * slots,), n, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, sh, pos, reduce="amin")
    count = torch.zeros(start.shape, dtype=torch.int64, device=dev)
    count.index_add_(0, sh, torch.ones(sh.shape, dtype=torch.int64, device=dev))
    return HashGrid(
        points=spts, src_index=order.to(torch.int32), mask=smask,
        key2=gather_rows(_hash2_cells(coords), order),
        start=start.reshape(lead + (slots,))[..., :table_size].to(torch.int32),
        count=count.reshape(lead + (slots,))[..., :table_size].to(torch.int32), cell_size=cell,
    )


def _neighbor_slot_ranges(grid: HashGrid, queries: torch.Tensor):
    """[..., Q, 3] -> (starts, counts, key2), each [..., Q, 27], of the 27
    neighbour cells."""
    qcell = _cell_coords(queries, grid.cell_size)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=queries.device)
    cells = qcell[..., :, None, :] + offs
    hs = _hash_cells(cells, grid.table_size)
    return _take(grid, grid.start, hs), _take(grid, grid.count, hs), _hash2_cells(cells)


def _cand_d2(grid: HashGrid, q: torch.Tensor, starts, counts, keys2, cap: int):
    """Candidates [..., cap] of the given slot ranges: (sorted positions,
    d2 with masked candidates at inf). ``q`` [..., 1, 3] broadcasts
    against the candidates' [..., cap, 3] points."""
    lane = torch.arange(cap, dtype=torch.int64, device=q.device)
    cand = starts[..., None].to(torch.int64) + lane
    valid = lane < torch.clamp(counts, max=cap)[..., None]
    cand = torch.clamp(cand, 0, grid.capacity - 1)
    d = q - _take(grid, grid.points, cand)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    valid &= ((_take(grid, grid.key2, cand) == keys2[..., None])
              & _take(grid, grid.mask, cand))
    return cand, torch.where(valid, d2, torch.inf)


def query_1nn(grid: HashGrid, queries: torch.Tensor, query_mask: torch.Tensor, radius, cap: int):
    """Nearest neighbour within ``radius`` per query (the GICP correspondence
    search, reference ``nano_gicp_impl.hpp:187-199``): (index into the
    grid's ORIGINAL point order or -1, squared distance, found); over B
    lanes' grid and [B, Q, 3] queries, each lane's."""
    dev = queries.device
    radius2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2
    starts, counts, keys2 = _neighbor_slot_ranges(grid, queries)
    best_d2 = torch.full(queries.shape[:-1], torch.inf, dtype=torch.float32, device=dev)
    best_sorted = torch.full(queries.shape[:-1], -1, dtype=torch.int64, device=dev)
    for o in range(len(_OFFSETS)):
        cand, d2 = _cand_d2(grid, queries[..., :, None, :], starts[..., o], counts[..., o],
                            keys2[..., o], cap)
        o_d2, o_min = torch.min(d2, dim=-1)  # first minimum
        better = o_d2 < best_d2
        best_d2 = torch.where(better, o_d2, best_d2)
        best_sorted = torch.where(better, torch.gather(cand, -1, o_min[..., None])[..., 0],
                                  best_sorted)
    found = query_mask & (best_d2 < radius2)
    idx = torch.where(found, _take(grid, grid.src_index, torch.clamp(best_sorted, min=0)), -1)
    return idx, best_d2, found


def query_knn(
    grid: HashGrid, queries: torch.Tensor, query_mask: torch.Tensor, k: int, cap: int,
    chunk: int = 4096,
):
    """k nearest neighbours within the 27-cell neighbourhood (the covariance
    kNN, reference ``nano_gicp_impl.hpp:310-321``, bounded by the cells):
    (indices [Q, k] into the original order, d2 [Q, k], valid [Q, k]),
    nearest first, equal distances in candidate order (``lax.top_k``'s
    order in the JAX version). Fewer than k found are masked. Over B lanes'
    grid and [B, Q, 3] queries, each lane's ([B, Q, k]), ``chunk`` queries
    of every lane a pass (the JAX version's chunks under ``jax.vmap``)."""
    q_total = queries.shape[-2]
    if q_total % chunk:
        raise ValueError(f"{q_total} queries are not a multiple of chunk {chunk}")
    idx = torch.empty(queries.shape[:-1] + (k,), dtype=torch.int32, device=queries.device)
    d2 = torch.empty(queries.shape[:-1] + (k,), dtype=torch.float32, device=queries.device)
    width = len(_OFFSETS) * cap
    for q0 in range(0, q_total, chunk):
        q = queries[..., q0:q0 + chunk, :]
        rows = q.shape[:-1] + (width,)
        starts, counts, keys2 = _neighbor_slot_ranges(grid, q)
        cand, dd = _cand_d2(grid, q[..., :, None, None, :], starts, counts, keys2, cap)
        d2[..., q0:q0 + chunk, :], pos = k_smallest(dd.reshape(rows), k)
        sorted_pos = torch.gather(cand.reshape(rows), -1, pos)
        idx[..., q0:q0 + chunk, :] = _take(grid, grid.src_index, sorted_pos)
    valid = query_mask[..., None] & torch.isfinite(d2)
    return torch.where(valid, idx, -1), d2, valid
