"""Micro-attribution of ``gicp.align`` and the frame's pieces at the
production shapes.

Port of the JAX package's ``tools/micro_align.py``.

    python3 tools_torch/micro_align.py

The bench configuration with device preprocessing (``production_cfg(False)``
with ``host_preprocess`` off, so the device step runs the voxel filter and
its float64 prefix scan on the raw scan), the bench world, the state after
3 frames through ``OdometryRunner`` and frame 3 on the wire at the raw
capacity. Rows, under the JAX tool's names: the S2S search alone ("pallas
1nn only": ``cuda_nn.query_1nn_sorted``, kernel K2, at the S2S radius),
``_update_correspondences``, ``_linearize``, a full-resolution S2S
``align``, the preprocessing pieces (NaN/crop mask, voxel filter, Morton
sort), the scan normals, the S2S target, the submap selection and
assembly, an S2M ``align``, the keyframe spawn and the whole
``odom_frame``; each with ``devprof.stage_profile``'s columns. The JAX
tool's "candidate chunks/tile" line becomes K2's own candidate counts (its
``visits`` output): the mean and the most chunks a 32-query sub-tile
visits, against the target's chunks.

Runs on the card and raises without one; on the CPU call :func:`run` with
``device="cpu"`` and a small config.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import production_cfg  # noqa: E402
from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend  # noqa: E402
from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import keyframes, pipeline  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.state import clone_state  # noqa: E402
from direct_lidar_odometry_tpu_torch.ops import cuda_nn, morton, preprocess as prep, voxel  # noqa: E402
from direct_lidar_odometry_tpu_torch.registration import gicp  # noqa: E402
from tools_torch import ablate_step, devprof  # noqa: E402

ROWS = ("pallas 1nn only", "update_correspondences", "full _linearize", "align (s2s, ~3 iters)",
        "prep mask/crop 131k", "voxel_downsample 131k", "morton sort 32k", "scan normals",
        "s2s make_target", "submap select+assemble", "s2m align", "keyframe maybe_spawn",
        "FULL odom_frame")


def candidate_chunks(tgt: gicp.GicpTarget, src: gicp.GicpSource, radius: float) -> dict:
    """K2's candidate chunks per 32-query sub-tile at ``radius`` (the
    kernel's ``visits`` output): mean over every sub-tile, mean over those
    with a candidate, the most, and the target's chunks."""
    q = src.points
    visits = torch.zeros(q.shape[0] // cuda_nn.SUB_TILE, dtype=torch.int32, device=q.device)
    cuda_nn.nn1_pruned(q, src.mask, tgt.points, tgt.mask, tgt.chunk_lo, tgt.chunk_hi, radius,
                       visits)
    live = visits[visits > 0].to(torch.float32)
    return dict(mean=float(visits.to(torch.float32).mean()),
                mean_live=float(live.mean()) if live.numel() else 0.0,
                max=int(visits.max()), chunks=int(tgt.chunk_lo.shape[-1]))


def run(device="cuda", cfg: DloConfig | None = None, frames: int = 3, n: int = 20,
        small: bool = False) -> list[dict]:
    """The 13 rows (``stage`` and ``stage_profile``'s columns, median of
    ``n``); the first row also carries ``candidate_chunks``. ``cfg``
    defaults to ``production_cfg(small)``; device preprocessing is forced."""
    cfg = (production_cfg(small) if cfg is None else cfg).replace(host_preprocess=False)
    fr = ablate_step.capture_frame(cfg, small, device, frames)
    cfg, dev, state = fr.cfg, fr.device, fr.state
    backend = resolve_backend(cfg)
    cap = cfg.shapes.cell_cap_1nn
    pts, msk = fr.points, fr.mask

    scan = pipeline.preprocess_scan(pts, msk, cfg, backend)
    nrm = pipeline._scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(scan.points, scan.mask, nrm.normals, nrm.valid)
    tgt = pipeline.s2s_target(cfg, state, 1, backend)
    g = state.last_delta
    r = cfg.gicp.s2s.max_correspondence_distance
    res = gicp.align(src, tgt, g, cfg.gicp.s2s, backend, cap)
    chunks = candidate_chunks(tgt, src, r)
    print(f"# device={dev.type} backend={backend} n_raw={cfg.shapes.n_raw} "
          f"n_scan={cfg.shapes.n_scan} s2s iters={res.iterations}", file=sys.stderr)
    print(f"# candidate chunks/sub-tile: mean {chunks['mean']} (live sub-tiles "
          f"{chunks['mean_live']}) max {chunks['max']} of {chunks['chunks']}", file=sys.stderr)

    crop = cfg.preprocessing.crop.size if cfg.preprocessing.crop.use else None
    c0 = prep.preprocess(PointCloud(pts, msk), crop)
    cv = voxel.voxel_downsample(c0, cfg.preprocessing.voxel_scan.res,
                                out_capacity=cfg.shapes.n_scan)
    five = torch.tensor(5.0, device=dev)

    def submap_fn(st):
        return pipeline.submap_stage(cfg, st, state.pose, five, fr.directions, None,
                                     backend)[0].submap_points

    def s2m_fn():
        return gicp.align(src, pipeline.s2m_target(state, backend), state.pose, cfg.gicp.s2m,
                          backend, cap)

    st_sub, st_full = clone_state(state), clone_state(state)
    kf_ring = clone_state(state.keyframes)
    stages = [
        lambda: cuda_nn.query_1nn_sorted(tgt.points, tgt.mask, tgt.chunk_lo, tgt.chunk_hi,
                                         scan.points, src.mask, r),
        lambda: gicp._update_correspondences(g, src, tgt, cfg.gicp.s2s, backend, cap),
        lambda: gicp._linearize(g, src, tgt, cfg.gicp.s2s, backend, cap=cap),
        lambda: gicp.align(src, tgt, g, cfg.gicp.s2s, backend, cap),
        lambda: prep.preprocess(PointCloud(pts, msk), crop),
        lambda: voxel.voxel_downsample(c0, cfg.preprocessing.voxel_scan.res,
                                       out_capacity=cfg.shapes.n_scan),
        lambda: morton.sort_order(cv.points, cv.mask),
        lambda: pipeline._scan_normals(scan, cfg, backend),
        lambda: pipeline.s2s_target(cfg, state, 1, backend),
        lambda: submap_fn(st_sub),
        s2m_fn,
        lambda: keyframes.maybe_spawn(kf_ring, scan, state.pose, cfg, five,
                                      backend=backend)[0].count,
        lambda: pipeline.odom_frame(cfg, fr.directions, st_full, pts, msk, fr.imu_prior),
    ]
    rows = [dict(stage=name, **devprof.stage_profile(fn, n, dev))
            for name, fn in zip(ROWS, stages)]
    rows[0]["candidate_chunks"] = chunks
    return rows


def parse_argv(argv: list[str]) -> dict:
    """:func:`run`'s arguments: none, as the JAX tool."""
    if argv:
        raise SystemExit(f"micro_align takes no arguments, got {argv}")
    return {}


def main() -> None:
    rows = run(**parse_argv(sys.argv[1:]))
    print(f"{'stage':28s} {devprof.PROFILE_HEADER}")
    for r in rows:
        print(f"{r['stage']:28s} {devprof.format_profile(r)}")
    for r in rows:
        print(f"# row {json.dumps(r)}")


if __name__ == "__main__":
    main()
