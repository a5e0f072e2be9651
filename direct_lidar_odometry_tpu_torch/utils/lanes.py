"""Helpers of the lane dimension (the batched step, ``parallel/batched.py``).

- :func:`per_lane` runs a function on each lane's slices and stacks the
  results. The batched step computes its reductions over a lane's points,
  its reducing products and its 4x4 pose products this way, each in the
  single-sequence step's own operation: on the card a reduction over
  [B, N, ...] (or a batched product) may add in another order than the
  same reduction over [N, ...], and a last-bit difference in an LM sum
  grows over the frames, so a lane would drift from its own single run
  (by 3.7e-4 m over 30 frames on an H100). Elementwise operations, the
  products of points by a lane's rotation, ``se3_exp`` and the batched 6x6
  solve give every lane the bits of its unbatched form, and stay batched.
  The plain versions of K1-K4 run their lanes this way too.
- :func:`lane_rows` indexes one row of each lane's ring.
- :func:`lanes_where` picks the lanes a branch runs for, on the device.
"""

from __future__ import annotations

import torch


def per_lane(fn, *args, lanes: int | None = None):
    """``fn`` over each lane: every tensor argument is cut to its lane
    (``t[b]``), the rest is passed as it is; the results (a tensor or a
    tuple of tensors) are stacked along a new leading lane dimension.
    ``lanes`` defaults to the first tensor argument's leading size."""
    if lanes is None:
        lanes = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    outs = [fn(*(a[b] if isinstance(a, torch.Tensor) else a for a in args))
            for b in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def lane_rows(idx: torch.Tensor):
    """The index of row ``idx[b]`` of each lane b: ``x[lane_rows(idx)]`` is
    ``x[b, idx[b]]`` for a [B] ``idx`` into [B, K, ...], and ``x[idx]`` for
    a 0-d ``idx`` (one sequence)."""
    if idx.dim() == 0:
        return idx
    return torch.arange(idx.shape[0], device=idx.device), idx


def lanes_where(flags: torch.Tensor, n: int) -> torch.Tensor:
    """The indices of the ``n`` lanes whose [B] ``flags`` are set, in lane
    order. ``n`` was read on the host with the flags, so the indices are
    computed on the device and nothing more is read back."""
    return torch.argsort((~flags).to(torch.uint8), stable=True)[:n]
