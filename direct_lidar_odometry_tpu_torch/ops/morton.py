"""Morton (Z-order) spatial sorting + chunk bounding boxes.

Counterpart of the JAX package's ``ops/morton.py``. Clouds are sorted by
Morton code so that runs of :data:`TARGET_CHUNK` consecutive points are
spatially compact; the per-chunk AABBs then let the pruned kernels
(``ops/cuda_nn.py``, ``ops/cuda_cov.py``) skip whole chunks whose box lies
beyond the search radius — the tile-granular analog of a kd-tree's pruning.

Every function takes a leading lane dimension as well: [B, N, 3] clouds
are sorted and chunked lane by lane (the batched step,
``parallel/batched.py``).

The reference's codes are uint32. PyTorch's uint32 support is thin
(especially on CUDA), so codes here are int64 holding the same 32-bit
values; the invalid sentinel ``0xFFFFFFFF`` still sorts after every valid
30-bit code.
"""

from __future__ import annotations

import torch

from direct_lidar_odometry_tpu_torch.core.cloud import gather_rows

# quantization cell for the 10-bit-per-axis Morton code. Only locality
# quality depends on this, never correctness; 1024 cells cover +-256 m.
DEFAULT_CELL = 0.5

# Target-side chunk granularity of the branch-and-bound kernels. The CUDA
# kernels hard-code the same value (csrc/*.cu kChunk).
TARGET_CHUNK = 512

INVALID_CODE = 0xFFFFFFFF


def part_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` (int64) so there are 2 zeros between bits."""
    x = x.to(torch.int64)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def interleave3(c: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer cell coordinates in [0, 1023] -> 30-bit Morton codes."""
    return part_bits(c[..., 0]) | (part_bits(c[..., 1]) << 1) | (part_bits(c[..., 2]) << 2)


def morton_codes(
    points: torch.Tensor, mask: torch.Tensor, cell: float = DEFAULT_CELL
) -> torch.Tensor:
    """[..., N,3],[..., N] -> int64 Z-order codes; invalid points get
    INVALID_CODE.

    The origin is the masked minimum, so codes are translation-invariant per
    cloud and the 10-bit range is spent on the cloud's actual extent.
    """
    origin = torch.amin(torch.where(mask[..., None], points, torch.inf), dim=-2, keepdim=True)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    q = torch.clamp((points - origin) / cell, 0.0, 1023.0).to(torch.int64)
    code = interleave3(q)
    return torch.where(mask, code, INVALID_CODE)


def sort_order(
    points: torch.Tensor, mask: torch.Tensor, cell: float = DEFAULT_CELL
) -> torch.Tensor:
    """[..., N] int64 permutation putting the cloud in Z-order, invalid last."""
    return torch.sort(morton_codes(points, mask, cell), stable=True).indices


def sort_cloud(
    points: torch.Tensor, mask: torch.Tensor, cell: float = DEFAULT_CELL
) -> tuple[torch.Tensor, torch.Tensor]:
    """Z-order the cloud: ``(points [..., N,3], mask [..., N])`` sorted,
    invalid last."""
    order = sort_order(points, mask, cell)
    return gather_rows(points, order), gather_rows(mask, order)


def chunk_aabbs(
    points: torch.Tensor, mask: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked per-chunk bounds. [..., N,3],[..., N] -> (lo [..., 3,C], hi
    [..., 3,C]).

    Empty chunks give (+inf, -inf), which makes every AABB-distance test
    against them +inf — always skipped, never wrong.
    """
    n = points.shape[-2]
    if n % chunk:
        raise ValueError(f"cloud size {n} is not a multiple of chunk {chunk}")
    c = n // chunk
    lead = points.shape[:-2]
    p = points.reshape(lead + (c, chunk, 3))
    m = mask.reshape(lead + (c, chunk, 1))
    lo = torch.amin(torch.where(m, p, torch.inf), dim=-2)    # [..., C, 3]
    hi = torch.amax(torch.where(m, p, -torch.inf), dim=-2)   # [..., C, 3]
    return lo.mT.contiguous(), hi.mT.contiguous()
