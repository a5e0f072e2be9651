#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from ``direct_lidar_odometry_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the per-frame path at ``cfg/tpu_dlo.yaml`` sizes, from
   Morton-sorted clouds of rendered OS1-64 scans: K2 (1-NN) with 32768
   queries against a 65536-point submap at r = 0.5, 1.0, 1.5; K1 (radius
   moments) over a 32768-point scan at r = 0.75 and a 16384-point keyframe
   at r = 1.5. Prints agreement and median times (CUDA events, 20 runs);
4. drive ``OdometryRunner(cfg, device="cuda")`` over 30 frames of the
   ray-cast urban world with every launch counter reset just before, and
   check the trajectory (ATE), the S2M correspondences of every frame, that
   both kernels were launched and that no plain version ran;
5. print one JSON line of per-kernel results, then the final JSON line.

It imports torch and the port, nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_FRAMES = 30
WARMUP = 3
TIMING_RUNS = 20
K2_TOL_REL = 2.0**-14   # near-tie slack between two winners' d2
K2_BORDER = 1e-6        # |d2 - r^2| <= K2_BORDER * r^2 counts as on the boundary
K2_FOUND_AGREE = 0.9999
K1_ATOL, K1_RTOL = 1e-3, 1e-5


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def slice_config():
    from direct_lidar_odometry_tpu_torch.config import load_config

    cfg_path = Path(__file__).resolve().parent / "cfg" / "tpu_dlo.yaml"
    return load_config(str(cfg_path), overrides={"nn_backend": "pallas", "posegraph.use": False})


def cuda_median_ms(fn, runs: int = TIMING_RUNS) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_world():
    from direct_lidar_odometry_tpu_torch.io import synthetic

    rng = np.random.default_rng(0)
    world = synthetic.make_urban_world(rng, n_frames=N_FRAMES, speed=1.0, n_dynamic=2)
    beams = synthetic.BeamModel()
    scans = [
        synthetic.render_raycast(world, t, rng, max_range=40.0, max_points=131072, beams=beams)
        for t in range(N_FRAMES)
    ]
    return world, scans


def kernel_inputs(cfg, world, scans, dev):
    """Morton-sorted clouds as the per-frame path builds them: the frame-4
    scan in the world frame (K2 queries), a submap of the frame 0-3
    keyframe clouds (K2 targets), the frame-0 scan and keyframe (K1)."""
    from direct_lidar_odometry_tpu_torch.core import cloud as cl, se3
    from direct_lidar_odometry_tpu_torch.odometry import keyframes, pipeline
    from direct_lidar_odometry_tpu_torch.ops import morton

    p0_inv = np.linalg.inv(world.poses[0])

    def scan_at(t):
        raw = cl.from_numpy(scans[t], cfg.shapes.n_raw, dev)
        pose = torch.tensor(p0_inv @ world.poses[t], dtype=torch.float32, device=dev)
        return pipeline.preprocess_scan(raw.points, raw.mask, cfg), pose

    kfs = []
    for t in range(4):
        scan, pose = scan_at(t)
        kc, _ = keyframes.make_keyframe_cloud(scan, pose, cfg)
        kfs.append(kc)
        if t == 0:
            scan0, kf0 = scan, kc
    sm_pts = torch.cat([k.points for k in kfs])
    sm_msk = torch.cat([k.mask for k in kfs])
    z = morton.sort_order(sm_pts, sm_msk)
    submap = cl.PointCloud(sm_pts[z].contiguous(), sm_msk[z].contiguous())
    scan4, pose4 = scan_at(4)
    q = torch.where(scan4.mask[:, None], se3.transform_points(pose4, scan4.points), cl.PAD_VALUE)
    queries = cl.PointCloud(q.contiguous(), scan4.mask)
    return queries, submap, scan0, kf0


def candidates(queries, targets, radius):
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn, morton

    qlo, qhi = morton.chunk_aabbs(queries.points, queries.mask, cuda_nn.TILE)
    tlo, thi = morton.chunk_aabbs(targets.points, targets.mask, morton.TARGET_CHUNK)
    return cuda_nn.candidate_chunks(qlo, qhi, tlo, thi, radius)


def check_k2(queries, targets, radius):
    from direct_lidar_odometry_tpu_torch.ops import cuda_nn

    cand, counts = candidates(queries, targets, radius)
    args = (queries.points, queries.mask, targets.points, targets.mask)
    ik, dk = cuda_nn.nn1_pruned(*args, cand, counts, radius)
    ip, dp = cuda_nn.nn1_plain(*args, radius)
    torch.cuda.synchronize()
    r2 = cuda_nn.f32_radius2(radius)
    fk, fp = ik >= 0, ip >= 0
    valid = queries.mask
    agree = float(((fk == fp) | ~valid).float().mean())
    dis = fk != fp
    d_dis = torch.where(fk, dk, dp)[dis]
    dis_ok = bool(torch.all(torch.abs(d_dis - r2) <= K2_BORDER * r2)) if dis.any() else True
    both = fk & fp
    diff = torch.abs(dk[both] - dp[both])
    near_tie = diff <= K2_TOL_REL * torch.maximum(dk[both], dp[both])
    max_err = float(diff.max()) if both.any() else 0.0
    idx_same = float((ik[both] == ip[both]).float().mean()) if both.any() else 1.0
    ms = cuda_median_ms(lambda: cuda_nn.nn1_pruned(*args, cand, counts, radius))
    plain_ms = cuda_median_ms(lambda: cuda_nn.nn1_plain(*args, radius))
    prep_ms = cuda_median_ms(lambda: candidates(queries, targets, radius))
    case = dict(
        radius=radius, queries=int(queries.points.shape[0]), targets=int(targets.points.shape[0]),
        found=int(fk.sum()), found_agree=agree, n_disagree=int(dis.sum()), idx_same=idx_same,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, candidate_ms=prep_ms,
    )
    print(f"# K2 nn1_pruned {case}")
    require(agree >= K2_FOUND_AGREE, f"K2 r={radius}: found agrees on {agree:.6f} < {K2_FOUND_AGREE}")
    require(dis_ok, f"K2 r={radius}: a found disagreement lies off the r^2 boundary")
    require(bool(torch.all(near_tie)), f"K2 r={radius}: winners' d2 differ beyond 2^-14 relative")
    require(int(fk.sum()) > 1000, f"K2 r={radius}: only {int(fk.sum())} queries found a neighbour")
    return case


def check_k1(cloud, radius):
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov

    cand, counts = candidates(cloud, cloud, radius)
    args = (cloud.points, cloud.mask, cloud.points, cloud.mask)
    mk = cuda_cov.cov_pruned(*args, cand, counts, radius)
    mp = cuda_cov.cov_plain(*args, radius)
    torch.cuda.synchronize()
    v = cloud.mask
    cnt_same = mk[:, 0] == mp[:, 0]
    n_cnt_diff = int((~cnt_same & v).sum())
    if n_cnt_diff:
        # a count may differ only through a pair on the r^2 boundary
        r2 = cuda_cov.f32_radius2(radius)
        rows = torch.nonzero(~cnt_same & v)[:, 0]
        d = cloud.points[None, :, :] - cloud.points[rows][:, None, :]
        d2 = torch.sum(d * d, dim=-1)
        on_border = torch.any(torch.abs(d2 - r2) <= K2_BORDER * r2, dim=1)
        require(bool(on_border.all()), f"K1 r={radius}: counts differ off the r^2 boundary")
    rows = v & cnt_same
    err = torch.abs(mk[rows] - mp[rows])
    max_err = float(err.max())
    close = bool(torch.all(err <= K1_ATOL + K1_RTOL * torch.abs(mp[rows])))
    ms = cuda_median_ms(lambda: cuda_cov.cov_pruned(*args, cand, counts, radius))
    plain_ms = cuda_median_ms(lambda: cuda_cov.cov_plain(*args, radius))
    prep_ms = cuda_median_ms(lambda: candidates(cloud, cloud, radius))
    case = dict(
        radius=radius, points=int(cloud.points.shape[0]), valid=int(v.sum()),
        mean_neighbours=float(mp[v, 0].mean()), n_count_diff=n_cnt_diff,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, candidate_ms=prep_ms,
    )
    print(f"# K1 cov_pruned {case}")
    require(close, f"K1 r={radius}: moments beyond atol {K1_ATOL} rtol {K1_RTOL}")
    return case


def drive(cfg, world, scans, device="cuda"):
    from direct_lidar_odometry_tpu_torch.io import evaluation
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn
    from direct_lidar_odometry_tpu_torch.utils import sync

    runner = OdometryRunner(cfg, device=device)
    cuda_nn.reset_launches()
    cuda_cov.reset_launches()
    sync.reset()
    reads = []
    for t, scan in enumerate(scans):
        before = sync.counts["host_reads"]
        runner.process_scan(scan, float(world.stamps[t]), sync=True)
        reads.append(sync.counts["host_reads"] - before)
    launches = {"nn1_pruned": dict(cuda_nn.launches), "cov_pruned": dict(cuda_cov.launches)}

    est = runner.trajectory()
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    rmse = evaluation.ate(est, gt, align=False).rmse
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    frame_ms = [s.wall_ms for s in runner.stats]
    corr = [int(s.result.s2m_num_corr) for s in runner.stats[1:]]
    timed = slice(1 + WARMUP, None)
    out = dict(
        frames=len(est), ate_m=rmse, path_m=path, keyframes=runner.num_keyframes(),
        median_ms_per_frame=float(np.median(frame_ms[timed])),
        host_reads_per_frame_median=float(np.median(reads[timed])),
        host_reads_per_frame_mean=float(np.mean(reads[timed])),
        min_s2m_num_corr=min(corr),
        s2s_iterations=[s.result.s2s_iterations for s in runner.stats[1:]],
        s2m_iterations=[s.result.s2m_iterations for s in runner.stats[1:]],
        launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(f"# main path {json.dumps(out)}")
    gate = max(0.10, 0.001 * path)
    require(rmse < gate, f"ATE {rmse:.4f} m >= {gate:.4f} m")
    require(min(corr) > 100, f"a frame has s2m_num_corr {min(corr)} <= 100")
    for name, cnt in launches.items():
        require(cnt["cuda"] > 0, f"{name} kernel was never launched on the main path")
        require(cnt["plain"] == 0, f"{name} plain version ran {cnt['plain']} times on the main path")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from direct_lidar_odometry_tpu_torch.ops import cuda_build

    _, build_s = cuda_build.build()
    cuda_build.library()
    print(f"# kernels built in {build_s:.1f} s from {[p.name for p in cuda_build.sources()]}")

    cfg = slice_config()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    world, scans = make_world()
    print(f"# rendered {len(scans)} scans in {time.perf_counter() - t0:.1f} s "
          f"({int(np.mean([len(s) for s in scans]))} points mean)")

    from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32

    pin_float32()
    queries, submap, scan0, kf0 = kernel_inputs(cfg, world, scans, dev)
    k2 = [check_k2(queries, submap, r) for r in (0.5, 1.0, 1.5)]
    k1 = [check_k1(scan0, 0.75), check_k1(kf0, 1.5)]

    main_path = drive(cfg, world, scans)

    kernels = [
        dict(name="nn1_pruned", route="cuda",
             source="direct_lidar_odometry_tpu_torch/csrc/nn1_pruned.cu",
             replaces="direct_lidar_odometry_tpu/ops/pallas_nn.py:192",
             launches=main_path["launches"]["nn1_pruned"]["cuda"],
             max_abs_err=max(c["max_abs_err"] for c in k2),
             ms=k2[0]["ms"], plain_ms=k2[0]["plain_ms"]),
        dict(name="cov_pruned", route="cuda",
             source="direct_lidar_odometry_tpu_torch/csrc/cov_pruned.cu",
             replaces="direct_lidar_odometry_tpu/ops/pallas_cov.py:117",
             launches=main_path["launches"]["cov_pruned"]["cuda"],
             max_abs_err=max(c["max_abs_err"] for c in k1),
             ms=k1[0]["ms"], plain_ms=k1[0]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
