"""Counted device-to-host reads.

Every place where the per-frame step needs a device value on the host — a
loop exit, a branch — goes through :func:`read`, which waits for the
device. The count is what a CUDA graph or a device-side fixed trip would
remove later; the runner and ``chip_smoke.py`` report it per frame.
"""

from __future__ import annotations

import torch

counts = {"host_reads": 0}


def reset() -> None:
    counts["host_reads"] = 0


def read(t: torch.Tensor) -> list | bool | int | float:
    """One host sync: the tensor's values as Python objects (``tolist``)."""
    counts["host_reads"] += 1
    return t.tolist()
