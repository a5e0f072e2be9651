"""Fixed-radius 1-NN: kernels K2 and K4 over a Morton-sorted target cloud,
and the exhaustive kernel K5.

Counterpart of the JAX package's ``ops/pallas_nn.py``: the pruned path
(``_pruned_1nn_one``, ``query_1nn_sorted``), the correspondence search of
every GICP iteration, and the exhaustive ``query_1nn``.

- :func:`nn1_pruned` is kernel K2's wrapper. It takes the target's chunk
  AABBs; on a CUDA tensor it launches ``csrc/nn1_pruned.cu``, which picks
  the candidate chunks of each 32-query sub-tile itself
  (:func:`subtile_candidates` is that selection in plain PyTorch); on a CPU
  tensor it runs :func:`nn1_plain`, the exhaustive plain PyTorch version
  of the same function. Nothing falls back from one to the other.
- :func:`nn1_pruned_mxu` is kernel K4's wrapper: the same kernel body on
  the distance expansion ``max((|q|^2 + |t|^2) - 2 q.t, 0)``, with the
  same inputs; its selection is :func:`expansion_candidates` and its
  plain version :func:`nn1_mxu_plain`.
- :func:`query_1nn_sorted` is the public entry with the JAX package's
  contract: it recomputes the winner's exact d2 after the search
  (``mxu=True`` selects K4).
- :func:`nn1_exhaustive` is kernel K5's wrapper (``csrc/nn1_exhaustive.cu``,
  the raw minimum over every valid target), plain version
  :func:`nn1_exhaustive_plain`; :func:`query_1nn` is the public entry. K5
  and K6 (``ops/cuda_cov.py``) first compact the valid targets into a dense
  array on the device (``csrc/dense_targets.cu``) and scan it on a grid of
  (query tile, target split) blocks; :func:`exhaustive_splits` sizes that
  grid.

The pruned kernels K1-K4 take a leading lane dimension (the JAX
package's batched entries under ``jax.vmap``, ``_pruned_1nn_batched``):
[B, Q, 3] queries against [B, T, 3] targets with [B, 3, C] chunk AABBs, B
independent clouds in one launch on a grid of (Q / 32, B) blocks, with
indices local to each lane. [Q, 3] inputs are one lane and give unbatched
outputs. A lane of a B-lane launch equals a launch of that lane alone bit
for bit; the plain versions take the same lane dimension and run lane by
lane.

Each kernel has its own launch counter, counted per route: ``"cuda"``
where the wrapper launched the kernel, ``"plain"`` where it ran the plain
version: ``launches`` (K2), ``mxu_launches`` (K4), ``exhaustive_launches``
(K5). A launch counts once whatever its number of lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.core.cloud import gather_rows
from direct_lidar_odometry_tpu_torch.ops import cuda_build, morton
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane

TILE = 128                    # queries per tile (one CUDA block row of K5, K6)
SUB_TILE = 32                 # queries per sub-tile (one CUDA block of K1-K4)
CHUNK = morton.TARGET_CHUNK   # targets per Morton chunk
MAX_CHUNKS = 1024             # chunks per target cloud, every pruned kernel
SCAN_BLOCKS_PER_SM = 16       # blocks of the K5/K6 scan grid per multiprocessor
MAX_SPLITS = 65535            # the grid's second dimension
MAX_LANES = 65535             # lanes of one K1-K4 launch (the grid's second dimension)

launches = {"cuda": 0, "plain": 0}
mxu_launches = {"cuda": 0, "plain": 0}
exhaustive_launches = {"cuda": 0, "plain": 0}

# the plain expansion folds invalid targets to this finite coordinate (an
# infinite one gives inf - inf = NaN in the expansion)
_EXPANSION_PAD = 1e6
# K4's selection slack factor (csrc/subtile_search.cuh kExpansionSlack)
EXPANSION_SLACK = 2.0**-19


def reset_launches() -> None:
    for counter in (launches, mxu_launches, exhaustive_launches):
        for k in counter:
            counter[k] = 0


def f32_radius2(radius: float) -> float:
    """r^2 rounded to float32, the value every radius test compares against."""
    return float(np.float32(float(radius) * float(radius)))


def subtile_gap2(
    queries: torch.Tensor, query_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor, sub: int = SUB_TILE,
) -> torch.Tensor:
    """Squared AABB gaps of every ``sub``-query sub-tile to every chunk, as
    the pruned kernels K1-K4 compute them inside the kernel
    (``csrc/subtile_search.cuh``): f32 [Q // sub, C].

    queries [Q,3] with Q % sub == 0, chunk_lo/chunk_hi [3, C] (masked chunk
    AABBs, :func:`ops.morton.chunk_aabbs`). The gap is
    (gx*gx + gy*gy) + gz*gz with gx = max(clo - qhi, qlo - chi, 0) over the
    sub-tile's masked AABB [qlo, qhi]. Rounding is monotone, so it never
    exceeds the rounded d^2 of a valid query and a valid target of the pair.
    Sub-tiles without a valid query and empty chunks (boxes of +inf, -inf)
    give +inf, never NaN.
    """
    qlo, qhi = morton.chunk_aabbs(queries, query_mask, sub)  # [3, Q // sub]
    below = chunk_lo[:, None, :] - qhi[:, :, None]           # [3, Q // sub, C]
    above = qlo[:, :, None] - chunk_hi[:, None, :]
    g = torch.clamp(torch.maximum(below, above), min=0.0)
    return (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]


def subtile_candidates(
    queries: torch.Tensor, query_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor,
    radius: float, sub: int = SUB_TILE,
) -> torch.Tensor:
    """The candidate chunks of every sub-tile, as K1-K3 select them at r:
    bool [Q // sub, C], True where :func:`subtile_gap2` <= f32(r^2). Every
    target within r of a valid query lies in a candidate chunk of the
    query's sub-tile."""
    return subtile_gap2(queries, query_mask, chunk_lo, chunk_hi, sub) <= f32_radius2(radius)


def _corner_norm2(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """|p|^2 of the [3, N] boxes' corners farthest from the origin, rounded
    as the kernel rounds it; +inf for empty boxes."""
    c = torch.maximum(lo.abs(), hi.abs())
    return (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]


def expansion_candidates(
    queries: torch.Tensor, query_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor,
    radius: float, sub: int = SUB_TILE,
) -> torch.Tensor:
    """K4's candidate chunks of every sub-tile: bool [Q // sub, C], True
    where :func:`subtile_gap2` is finite and <= r^2 + slack, with slack =
    ((|q|max^2 + |t|max^2) + r^2) * 2^-19 over the sub-tile's and the
    chunk's box corners, each step rounded as the kernel rounds it. The
    expansion can read a pair up to ~8u (|q|^2 + |t|^2 + r^2) below its
    rounded d^2 (u = 2^-24), so every target whose expansion d2 is < r^2
    lies in a candidate chunk, and K4 finds what :func:`nn1_mxu_plain`
    finds."""
    r2 = f32_radius2(radius)
    qlo, qhi = morton.chunk_aabbs(queries, query_mask, sub)
    norms = _corner_norm2(qlo, qhi)[:, None] + _corner_norm2(chunk_lo, chunk_hi)[None, :]
    bound = r2 + (norms + r2) * EXPANSION_SLACK
    gap2 = subtile_gap2(queries, query_mask, chunk_lo, chunk_hi, sub)
    return torch.isfinite(gap2) & (gap2 <= bound)


def plain_query_step(n_targets: int, device: torch.device) -> int:
    """Queries per step of the plain versions: bounds each [chunk, T]
    temporary at 2^22 (CPU) or 2^25 (CUDA) elements."""
    budget = 1 << (25 if device.type == "cuda" else 22)
    return max(1, budget // max(n_targets, 1))


def _expansion_targets(targets: torch.Tensor, target_mask: torch.Tensor):
    """The plain expansion's targets: invalid ones folded to the finite pad,
    and the |t|^2 row (tx*tx + ty*ty) + tz*tz, as the JAX package's wrapper
    prepares them."""
    folded = torch.where(target_mask[:, None], targets, _EXPANSION_PAD).contiguous()
    tx, ty, tz = folded.unbind(-1)
    return folded, ((tx * tx + ty * ty) + tz * tz).contiguous()


def _min_plain(queries: torch.Tensor, targets: torch.Tensor, target_mask: torch.Tensor,
               expansion: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw minimum over the targets per query, in steps of queries: (d2 f32
    [Q], index int64 [Q]; the first index among equal minima).

    Coordinate differences d2 = (dx*dx + dy*dy) + dz*dz with invalid targets
    at +inf (the kernels' order), or with ``expansion`` the K4 distance
    max((|q|^2 + |t|^2) - 2 q.t, 0) over targets folded to the finite pad,
    with q.t = (qx*tx + qy*ty) + qz*tz and |.|^2 in the same order.
    """
    q_total = queries.shape[0]
    dmin = torch.empty((q_total,), dtype=torch.float32, device=queries.device)
    amin = torch.empty((q_total,), dtype=torch.int64, device=queries.device)
    if expansion:
        targets, t2 = _expansion_targets(targets, target_mask)
    tx, ty, tz = targets[:, 0], targets[:, 1], targets[:, 2]
    step = plain_query_step(targets.shape[0], queries.device)
    for s in range(0, q_total, step):
        q = queries[s:s + step]
        qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
        if expansion:
            q2 = (qx * qx + qy * qy) + qz * qz
            g = (qx * tx + qy * ty) + qz * tz
            d2 = torch.clamp((q2 + t2) - 2.0 * g, min=0.0)
        else:
            dx, dy, dz = qx - tx, qy - ty, qz - tz
            d2 = (dx * dx + dy * dy) + dz * dz
            d2 = torch.where(target_mask[None, :], d2, torch.inf)
        dmin[s:s + step], amin[s:s + step] = torch.min(d2, dim=1)
    return dmin, amin


def _radius_plain(queries, query_mask, targets, target_mask, radius, expansion=False):
    r2 = f32_radius2(radius)
    dmin, amin = _min_plain(queries, targets, target_mask, expansion)
    found = query_mask & (dmin < r2)
    return torch.where(found, amin.to(torch.int32), -1), torch.where(found, dmin, torch.inf)


def nn1_plain(
    queries: torch.Tensor, query_mask: torch.Tensor,
    targets: torch.Tensor, target_mask: torch.Tensor,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: exhaustive 1-NN within radius.

    Coordinate differences, d2 = (dx*dx + dy*dy) + dz*dz (the kernel's
    order), ties to the lower target index. Returns (idx int32 [Q], -1 =
    none; d2 f32 [Q], +inf where none); [B, Q, 3] queries against [B, T, 3]
    targets give [B, Q] outputs, lane by lane.
    """
    if queries.dim() == 3:
        return per_lane(nn1_plain, queries, query_mask, targets, target_mask, radius,
                        lanes=queries.shape[0])
    return _radius_plain(queries, query_mask, targets, target_mask, radius)


def nn1_mxu_plain(
    queries: torch.Tensor, query_mask: torch.Tensor,
    targets: torch.Tensor, target_mask: torch.Tensor,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: :func:`nn1_plain` on the distance
    expansion, evaluated in the kernel's order (so the two agree bit for
    bit). Returns (idx int32 [Q], expansion d2 f32 [Q], +inf where none);
    with a lane dimension, as :func:`nn1_plain`."""
    if queries.dim() == 3:
        return per_lane(nn1_mxu_plain, queries, query_mask, targets, target_mask, radius,
                        lanes=queries.shape[0])
    return _radius_plain(queries, query_mask, targets, target_mask, radius, expansion=True)


def nn1_exhaustive_plain(
    queries: torch.Tensor, targets: torch.Tensor, target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: the raw nearest valid target of every
    query with no radius (idx int32 [Q]; d2 f32 [Q]); -1 and +inf only
    where every target is invalid."""
    dmin, amin = _min_plain(queries, targets, target_mask)
    return torch.where(torch.isinf(dmin), -1, amin.to(torch.int32)), dmin


def _check_tensors(expect: dict, **tensors) -> None:
    """Every tensor contiguous, on the queries' device, of its ``expect`` dtype."""
    device = tensors["queries"].device
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, queries on {device}")
    for name, t in tensors.items():
        if t.dtype != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {t.dtype}")


def _check_sizes(q_total: int, t_total: int) -> None:
    if q_total % TILE or t_total % CHUNK:
        raise ValueError(f"need Q % {TILE} == 0 and T % {CHUNK} == 0, got Q={q_total} T={t_total}")


def check_search_inputs(queries, query_mask, targets, target_mask, chunk_lo, chunk_hi,
                        visits=None) -> int:
    """Inputs of the sub-tile kernels K1-K4: the clouds, the targets' [3, C]
    chunk AABBs with C = T // 512 <= 1024, and the optional int32
    [Q // 32] ``visits`` output; each with the same leading lane dimension
    [B] or none. Returns the lanes (1 without a lane dimension)."""
    tensors = dict(queries=queries, query_mask=query_mask, targets=targets,
                   target_mask=target_mask, chunk_lo=chunk_lo, chunk_hi=chunk_hi)
    if visits is not None:
        tensors["visits"] = visits
    _check_tensors(dict(queries=torch.float32, targets=torch.float32, query_mask=torch.bool,
                        target_mask=torch.bool, chunk_lo=torch.float32,
                        chunk_hi=torch.float32, visits=torch.int32), **tensors)
    if queries.dim() not in (2, 3):
        raise ValueError(f"queries must be [Q, 3] or [B, Q, 3], got {tuple(queries.shape)}")
    lead = tuple(queries.shape[:-2])
    q_total, t_total = queries.shape[-2], targets.shape[-2]
    _check_sizes(q_total, t_total)
    n_chunks = t_total // CHUNK
    want = dict(queries=(q_total, 3), query_mask=(q_total,), targets=(t_total, 3),
                target_mask=(t_total,), chunk_lo=(3, n_chunks), chunk_hi=(3, n_chunks),
                visits=(q_total // SUB_TILE,))
    for name, t in tensors.items():
        if tuple(t.shape) != lead + want[name]:
            what = "chunk AABBs" if name.startswith("chunk") else name
            raise ValueError(f"{what} {tuple(t.shape)} do not match queries "
                             f"{tuple(queries.shape)} and targets {tuple(targets.shape)}")
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"{n_chunks} chunks exceed the kernels' {MAX_CHUNKS}")
    lanes = lead[0] if lead else 1
    if lanes > MAX_LANES:
        raise ValueError(f"{lanes} lanes exceed the kernels' {MAX_LANES}")
    return lanes


def plain_visits(visits, queries, query_mask, chunk_lo, chunk_hi, radius,
                 expansion: bool = False) -> None:
    """The CPU route of the ``visits`` output of K1/K2 (each sub-tile's
    candidate count from :func:`subtile_candidates`) and of K4
    (``expansion``, from :func:`expansion_candidates`), lane by lane."""
    if visits is not None:
        select = expansion_candidates if expansion else subtile_candidates
        if queries.dim() == 3:
            cand = per_lane(select, queries, query_mask, chunk_lo, chunk_hi, radius,
                            lanes=queries.shape[0])
        else:
            cand = select(queries, query_mask, chunk_lo, chunk_hi, radius)
        visits.copy_(cand.sum(dim=-1, dtype=torch.int32))


def check_exhaustive_inputs(queries, targets, target_mask):
    """Inputs of the exhaustive kernels K5/K6: contiguous, on one device,
    f32 points, a bool mask, Q % 128 == 0 (T of any size)."""
    for name, t in dict(queries=queries, targets=targets, target_mask=target_mask).items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
    if queries.dtype != torch.float32 or targets.dtype != torch.float32:
        raise ValueError("queries and targets must be float32")
    if target_mask.dtype != torch.bool:
        raise ValueError(f"target_mask must be bool, got {target_mask.dtype}")
    if queries.shape[0] % TILE:
        raise ValueError(f"need Q % {TILE} == 0, got Q={queries.shape[0]}")


def _pruned_search(
    expansion: bool, queries, query_mask, targets, target_mask, chunk_lo, chunk_hi,
    radius: float, visits,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 (or with ``expansion`` K4): check, then the plain version on a CPU
    tensor or the kernel on a CUDA one."""
    lanes = check_search_inputs(queries, query_mask, targets, target_mask, chunk_lo, chunk_hi,
                                visits)
    counter = mxu_launches if expansion else launches
    if queries.device.type == "cpu":
        counter["plain"] += 1
        plain_visits(visits, queries, query_mask, chunk_lo, chunk_hi, radius, expansion)
        plain = nn1_mxu_plain if expansion else nn1_plain
        return plain(queries, query_mask, targets, target_mask, radius)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    name = "dlo_nn1_pruned_mxu" if expansion else "dlo_nn1_pruned"
    q_total = queries.shape[-2]
    idx = torch.empty(queries.shape[:-1], dtype=torch.int32, device=queries.device)
    d2 = torch.empty(queries.shape[:-1], dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        err = getattr(cuda_build.library(), name)(
            queries.data_ptr(), query_mask.data_ptr(), targets.data_ptr(),
            target_mask.data_ptr(), chunk_lo.data_ptr(), chunk_hi.data_ptr(),
            q_total, chunk_lo.shape[-1], lanes, f32_radius2(radius), idx.data_ptr(), d2.data_ptr(),
            None if visits is None else visits.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream,
        )
    cuda_build.check(err, name)
    counter["cuda"] += 1
    return idx, d2


def nn1_pruned(
    queries: torch.Tensor, query_mask: torch.Tensor,
    targets: torch.Tensor, target_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor,
    radius: float, visits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of kernel K2: (idx int32 [Q], d2 f32 [Q]) as :func:`nn1_plain`.

    queries [Q,3] f32 with Q % 128 == 0; targets [T,3] f32 Morton-sorted
    with T % 512 == 0 and T <= 512 * 1024; chunk_lo/chunk_hi the targets'
    [3, T//512] masked chunk AABBs (:func:`ops.morton.chunk_aabbs`, computed
    once per target cloud). The kernel selects the candidate chunks of each
    32-query sub-tile itself. ``visits`` (optional, int32 [Q // 32])
    receives each sub-tile's candidate count: the kernel evaluates
    32 * 512 * visits.sum() pairs. A CUDA tensor launches the kernel on the
    current stream (no allocation inside, no synchronization); a CPU tensor
    runs the plain version and fills ``visits`` from
    :func:`subtile_candidates`. With a leading lane dimension (queries
    [B, Q, 3], targets [B, T, 3], AABBs [B, 3, C], ``visits`` [B, Q // 32])
    one launch searches B independent lanes and returns [B, Q] outputs.
    """
    return _pruned_search(False, queries, query_mask, targets, target_mask,
                          chunk_lo, chunk_hi, radius, visits)


def nn1_pruned_mxu(
    queries: torch.Tensor, query_mask: torch.Tensor,
    targets: torch.Tensor, target_mask: torch.Tensor,
    chunk_lo: torch.Tensor, chunk_hi: torch.Tensor,
    radius: float, visits: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of kernel K4: (idx int32 [Q], expansion d2 f32 [Q]) as
    :func:`nn1_mxu_plain`, with the inputs and the ``visits`` output of
    :func:`nn1_pruned`; the CPU route fills ``visits`` from
    :func:`expansion_candidates`. The kernel computes |t|^2 and masks the
    invalid targets itself."""
    return _pruned_search(True, queries, query_mask, targets, target_mask,
                          chunk_lo, chunk_hi, radius, visits)


def query_1nn_sorted(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    chunk_lo: torch.Tensor,
    chunk_hi: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    radius: float,
    mxu: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN within ``radius`` over a Morton-sorted target cloud.

    ``chunk_lo``/``chunk_hi`` are the targets' [3, T//512] masked chunk
    AABBs; every argument may carry a leading lane dimension [B] (one
    launch, [B, Q] outputs, indices local to each lane). Returns (idx [Q] int64, -1 where not found; exact d2 [Q], +inf
    where no winner; found [Q] bool), the JAX package's contract.
    ``mxu=True`` searches with kernel K4's distance expansion: the winner
    may differ among near-ties and borderline radius hits, the reported d2
    stays exact.
    """
    search = nn1_pruned_mxu if mxu else nn1_pruned
    best_idx, _ = search(queries, query_mask, target_points, target_mask,
                         chunk_lo, chunk_hi, radius)
    best_idx = best_idx.to(torch.int64)
    # the winner's d2 from the index, in the public contract's own form
    sel = gather_rows(target_points, torch.clamp(best_idx, min=0))
    best_d2 = torch.sum((queries - sel) ** 2, dim=-1)
    found = query_mask & (best_idx >= 0) & (best_d2 < f32_radius2(radius))
    best_d2 = torch.where(best_idx >= 0, best_d2, torch.inf)
    return torch.where(found, best_idx, -1), best_d2, found


def exhaustive_splits(q_total: int, t_total: int, n_sms: int) -> int:
    """Target splits of the K5/K6 scan grid: enough that the Q // 128 query
    tiles times the splits come to about ``SCAN_BLOCKS_PER_SM`` blocks per
    multiprocessor, at most one split per 512-target chunk the cloud could
    fill. Sized from the slot count T: the valid count stays on the device,
    where each split takes its share of the chunks actually filled."""
    tiles = max(q_total // TILE, 1)
    most = min(max(-(-t_total // CHUNK), 1), MAX_SPLITS)
    return max(1, min(round(SCAN_BLOCKS_PER_SM * n_sms / tiles), most))


def check_scan_stats(stats: torch.Tensor | None, queries: torch.Tensor) -> None:
    if stats is not None and (stats.dtype != torch.int32 or stats.shape != (2,)
                              or stats.device != queries.device
                              or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous int32 [2] tensor on the queries' device")


def plain_scan_stats(stats: torch.Tensor | None, q_total: int,
                     target_mask: torch.Tensor) -> None:
    """The CPU route of the ``stats`` output of K5/K6: (valid targets,
    chunk scans summed over the grid's blocks). The splits share the
    ceil(valid / 512) dense chunks, so every query tile scans each once."""
    if stats is not None:
        n_valid = int(target_mask.sum())
        stats.copy_(torch.tensor([n_valid, (q_total // TILE) * -(-n_valid // CHUNK)],
                                 dtype=torch.int32))


def exhaustive_workspace(queries: torch.Tensor, targets: torch.Tensor,
                         stats: torch.Tensor | None):
    """What a K5/K6 launch needs beside its inputs, on the queries' CUDA
    device: (splits of the scan grid, the dense target array's buffer
    [T rounded up to 512, 4] f32, the int32 [2] ``stats``)."""
    dev = queries.device
    n_splits = exhaustive_splits(queries.shape[0], targets.shape[0],
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    capacity = -(-targets.shape[0] // CHUNK) * CHUNK
    dense = torch.empty((capacity, 4), dtype=torch.float32, device=dev)
    if stats is None:
        stats = torch.empty((2,), dtype=torch.int32, device=dev)
    return n_splits, dense, stats


def nn1_exhaustive(
    queries: torch.Tensor, targets: torch.Tensor, target_mask: torch.Tensor,
    stats: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of kernel K5: (idx int32 [Q], raw d2 f32 [Q]) as
    :func:`nn1_exhaustive_plain`. queries [Q,3] f32 with Q % 128 == 0;
    targets [T,3] f32 of any T, in any order. ``stats`` (optional, int32
    [2]) receives the valid targets' count and the 512-target chunk scans
    summed over the grid's blocks: the kernel evaluates
    128 * 512 * stats[1] pairs. A CUDA tensor launches the pre-pass, the
    scan and the merge on the current stream (no synchronization, no host
    read of the count); a CPU tensor runs the plain version and fills
    ``stats`` with the counts any grid gives."""
    check_exhaustive_inputs(queries, targets, target_mask)
    check_scan_stats(stats, queries)
    q_total = queries.shape[0]
    if queries.device.type == "cpu":
        exhaustive_launches["plain"] += 1
        plain_scan_stats(stats, q_total, target_mask)
        return nn1_exhaustive_plain(queries, targets, target_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    n_splits, dense, stats = exhaustive_workspace(queries, targets, stats)
    part = torch.empty((n_splits, q_total), dtype=torch.int64, device=queries.device)
    idx = torch.empty((q_total,), dtype=torch.int32, device=queries.device)
    d2 = torch.empty((q_total,), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        err = cuda_build.library().dlo_nn1_exhaustive(
            queries.data_ptr(), targets.data_ptr(), target_mask.data_ptr(),
            q_total, targets.shape[0], n_splits, dense.data_ptr(), stats.data_ptr(),
            part.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream,
        )
    cuda_build.check(err, "nn1_exhaustive")
    exhaustive_launches["cuda"] += 1
    return idx, d2


def query_1nn(
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    radius: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exhaustive exact 1-NN (kernel K5), the JAX package's ``query_1nn``
    contract: (idx [Q] int64, -1 where not found; the raw nearest d2 [Q],
    reported even beyond ``radius`` and +inf only when every target is
    invalid; found [Q] = query_mask & (d2 < r^2))."""
    best_idx, best_d2 = nn1_exhaustive(queries, target_points, target_mask)
    r = np.float32(radius)
    found = query_mask & (best_d2 < float(r * r))  # the reference's f32(r)**2
    return torch.where(found, best_idx.to(torch.int64), -1), best_d2, found
