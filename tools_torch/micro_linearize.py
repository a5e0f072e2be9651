"""Micro-bench: the pruned NN kernel alone against the GICP linearization,
fused and unfused.

Port of the JAX package's ``tools/micro_linearize.py``.

    python3 tools_torch/micro_linearize.py [ns nt]

The JAX tool's clouds: ``ns`` source points (32768) drawn uniformly in an
80 x 80 x 8 m box from ``rng(0)``, ``nt`` targets (65536) resampled from
them with 0.1 m noise, random unit normals, both clouds Morton-sorted (the
source normals left in draw order, as in the JAX tool), at the S2M gate of
the default configuration. Rows: "NN kernel alone" (``query_1nn_sorted``,
kernel K2), "_linearize fused cold" (kernel K3), "_linearize fused seeded"
(K3 warm-started from the cold pass's correspondences at a pose moved by
an iteration's mm-scale delta, ``seed_corr``) and "_linearize unfused" (K2
and the PyTorch sums), each with ``devprof.stage_profile``'s columns.

Runs on the card and raises without one; on the CPU call :func:`run` with
``device="cpu"`` and small ``ns`` and ``nt``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.ops import cuda_nn, morton  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device  # noqa: E402
from direct_lidar_odometry_tpu_torch.registration import gicp  # noqa: E402
from tools_torch import devprof  # noqa: E402

ROWS = ("NN kernel alone", "_linearize fused cold", "_linearize fused seeded",
        "_linearize unfused")
CAP = 32  # the JAX tool's cap argument (unused by the pruned backends)


def clouds(ns: int, nt: int, device) -> tuple[gicp.GicpSource, gicp.GicpTarget]:
    """The JAX tool's source and target clouds."""
    rng = np.random.default_rng(0)
    src_pts = (rng.random((ns, 3)) * np.array([80, 80, 8]) - np.array([40, 40, 4])).astype(np.float32)
    tgt_pts = src_pts[rng.integers(0, ns, nt)] + rng.normal(0, 0.1, (nt, 3)).astype(np.float32)
    src_n = rng.normal(size=(ns, 3)).astype(np.float32)
    src_n /= np.linalg.norm(src_n, axis=1, keepdims=True)
    tgt_n = rng.normal(size=(nt, 3)).astype(np.float32)
    tgt_n /= np.linalg.norm(tgt_n, axis=1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sp, sm = morton.sort_cloud(t(src_pts), torch.ones(ns, dtype=torch.bool, device=device))
    tp, tm = morton.sort_cloud(t(tgt_pts), torch.ones(nt, dtype=torch.bool, device=device))
    ones_s = torch.ones(ns, dtype=torch.bool, device=device)
    ones_t = torch.ones(nt, dtype=torch.bool, device=device)
    src = gicp.GicpSource(points=sp.contiguous(), mask=sm, normals=t(src_n), normals_valid=ones_s)
    tgt = gicp.make_target(tp.contiguous(), tm, t(tgt_n), ones_t)
    return src, tgt


def run(ns: int = 32768, nt: int = 65536, device="cuda", n: int = 16) -> list[dict]:
    """The four rows (``stage`` and ``stage_profile``'s columns, median of
    ``n``)."""
    dev = require_device(device)
    stage = DloConfig().gicp.s2m
    src, tgt = clouds(ns, nt, dev)
    x0 = torch.eye(4, dtype=torch.float32, device=dev)
    corr0 = gicp._linearize(x0, src, tgt, stage, "pallas_fused", cap=CAP).corr
    # moved like one GICP iteration's delta (mm-scale)
    x1 = x0.clone()
    x1[0, 3] += 0.004
    x1[1, 3] -= 0.003
    radius = stage.max_correspondence_distance
    stages = [
        lambda: cuda_nn.query_1nn_sorted(tgt.points, tgt.mask, tgt.chunk_lo, tgt.chunk_hi,
                                         src.points, src.mask, radius),
        lambda: gicp._linearize(x0, src, tgt, stage, "pallas_fused", cap=CAP),
        lambda: gicp._linearize(x1, src, tgt, stage, "pallas_fused", seed_corr=corr0, cap=CAP),
        lambda: gicp._linearize(x0, src, tgt, stage, "pallas", cap=CAP),
    ]
    return [dict(stage=name, **devprof.stage_profile(fn, n, dev))
            for name, fn in zip(ROWS, stages)]


def parse_argv(argv: list[str]) -> dict:
    """:func:`run`'s arguments from ``[ns nt]`` (default the JAX tool's
    32768 and 65536)."""
    if len(argv) not in (0, 2):
        raise SystemExit(f"usage: [ns nt], got {argv}")
    return dict(ns=int(argv[0]), nt=int(argv[1])) if argv else {}


def main() -> None:
    rows = run(**parse_argv(sys.argv[1:]))
    print(f"{'stage':24s} {devprof.PROFILE_HEADER}")
    for r in rows:
        print(f"{r['stage']:24s} {devprof.format_profile(r)}")
    for r in rows:
        print(f"# row {json.dumps(r)}")


if __name__ == "__main__":
    main()
