"""Command-line runner of the PyTorch port — the process entry point.

Counterpart of the JAX package's ``cli.py`` (the reference's ROS launch
graph, ``launch/dlo.launch``, as one offline process): read scans (a KITTI
sequence directory or a synthetic ray-cast world), run the per-frame step
on ``--device``, print the dashboard, write the trajectory (KITTI and TUM
formats), export the keyframe map (PLY), checkpoint and resume, and report
ATE/RPE against ground truth. The flags are the JAX CLI's, plus
``--device`` (default ``cuda``; with no CUDA device that raises, there is
no move to the CPU). KITTI scans are read as the JAX CLI reads them: xyzi
rows with ``map.carry_intensity`` (the map PLY then carries intensity,
``OdometryRunner.build_map_xyzi``), else through the native background
prefetcher (``io/native.py`` ``ScanFeeder``, raw reads) when the host
library builds, else with the numpy reader.

    python -m direct_lidar_odometry_tpu_torch --synthetic 30 --config cfg/tpu_dlo.yaml \\
        --set nn_backend=pallas_fused --eval --map-ply map.ply
    python -m direct_lidar_odometry_tpu_torch --kitti /data/kitti --sequence 00 \\
        --config cfg/tpu_dlo.yaml --eval

With ``posegraph.use`` (on in ``cfg/tpu_dlo.yaml``) the summary counts the
loop-closure rounds and the loop edges accepted. Every single-sequence
option of the config runs, ``host_preprocess`` and every ``nn_backend``
included.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("direct_lidar_odometry_tpu_torch")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti", help="KITTI odometry dataset root")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run N synthetic frames (no dataset needed)")
    ap.add_argument("--sequence", default="00", help="KITTI sequence id")
    ap.add_argument("--config", help="YAML config (see cfg/tpu_dlo.yaml)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="dotted config override, e.g. gicp.s2s.max_iterations=16")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the per-frame step (cuda, cuda:1, cpu)")
    ap.add_argument("--frames", type=int, default=None, help="limit frame count")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--traj-kitti", default="trajectory_kitti.txt")
    ap.add_argument("--traj-tum", default="trajectory_tum.txt")
    ap.add_argument("--map-ply", default=None, help="export map as PLY")
    ap.add_argument("--map-live", action="store_true",
                    help="with --map-ply: also re-export the map every "
                         "1/map.publish_freq seconds of DATA time during the "
                         "run (the reference's periodically published map "
                         "topic, map.cc:100-131); each export synchronizes "
                         "and rebuilds the map. The final map is written "
                         "either way.")
    ap.add_argument("--checkpoint", default=None, help="save state here at exit")
    ap.add_argument("--resume", default=None, help="restore state from checkpoint")
    ap.add_argument("--eval", action="store_true",
                    help="report ATE/RPE against ground truth if available")
    ap.add_argument("--quiet", action="store_true", help="no per-frame dashboard")
    ap.add_argument("--dashboard-every", type=int, default=10)
    return ap


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return key, val.lower() == "true"
    return key, val


def _frames(args, cfg):
    """(iterator of (scan, stamp), ground-truth poses or None)."""
    from direct_lidar_odometry_tpu_torch.io import kitti, native, synthetic

    if args.kitti:
        seq = kitti.load_sequence(args.kitti, args.sequence)
        n_frames = min(len(seq), args.frames or len(seq))
        if cfg.map.carry_intensity:
            # xyzi rows for the runner's intensity sidecar (the odometry
            # itself never reads the intensity)
            frames = ((seq.scan_xyzi(i), float(seq.stamps[i])) for i in range(n_frames))
        elif native.available():
            frames = _fed_frames(seq, n_frames, cfg)
        else:
            frames = ((seq.scan(i), float(seq.stamps[i])) for i in range(n_frames))
        return frames, seq.poses
    rng = np.random.default_rng(0)
    n_frames = args.frames or args.synthetic
    # ray-cast urban world with an OS1-64 beam model (the JAX CLI's demo
    # world); beam resolution scales with the raw-scan capacity
    if cfg.shapes.n_raw >= 65536:
        world = synthetic.make_urban_world(rng, n_frames=n_frames, speed=1.0, n_dynamic=2)
        beams = synthetic.BeamModel()
        max_range = 40.0
    else:
        world = synthetic.make_urban_world(rng, n_frames=n_frames, speed=0.4, corridor=7.0,
                                           n_dynamic=1)
        beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
        max_range = 13.0
    frames = (
        (synthetic.render_scan(world, i, rng, max_range=max_range,
                               max_points=cfg.shapes.n_raw, beams=beams),
         float(world.stamps[i]))
        for i in range(n_frames)
    )
    return frames, world.poses


def _fed_frames(seq, n_frames, cfg):
    """The native background prefetcher with raw reads only (``res=0`` and
    no crop: preprocessing stays with the runner)."""
    from direct_lidar_odometry_tpu_torch.io import native

    feeder = native.ScanFeeder(seq.files[:n_frames], cap=cfg.shapes.n_raw, crop_size=0.0,
                               res=0.0)
    try:
        for i, scan in feeder:
            yield scan, float(seq.stamps[i])
    finally:
        feeder.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from direct_lidar_odometry_tpu_torch.config import load_config
    from direct_lidar_odometry_tpu_torch.io import evaluation, ply, trajectory
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu_torch.utils import checkpoint, profiling

    cfg = load_config(args.config, dict(_parse_override(s) for s in args.set))
    runner = OdometryRunner(cfg, device=args.device)
    timing = profiling.TimingStats()
    cpu_mon = profiling.CpuMonitor()  # CPU load/cores (odom.cc:1386-1403)

    # graceful shutdown: finish the frame, write outputs (the reference's
    # SIGTERM -> abort timer -> stop() analog, odom_node.cc:12-16); only the
    # main thread may install handlers, and they are restored on return
    stop = {"flag": False}
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            handlers[sig] = signal.signal(sig, lambda *_: stop.__setitem__("flag", True))

    frames, gt_poses = _frames(args, cfg)
    if args.resume:
        runner.state, extra = checkpoint.load_state(args.resume, cfg, runner.device)
        runner.prev_stamp = extra.get("prev_stamp")
        print(f"resumed from {args.resume}", file=sys.stderr)

    # --- main loop --------------------------------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    distance = 0.0
    last_pos = None
    next_map_stamp = None  # --map-live schedule (cfg.map.publish_freq Hz)
    try:
        for i, (scan, stamp) in enumerate(frames):
            if stop["flag"]:
                print("interrupted — writing outputs", file=sys.stderr)
                break
            res = runner.process_scan(scan, stamp)
            if (args.map_live and args.map_ply and cfg.map.publish_freq > 0
                    and runner.state is not None):
                if next_map_stamp is None:
                    next_map_stamp = stamp + 1.0 / cfg.map.publish_freq
                elif stamp >= next_map_stamp:
                    m_live = runner.build_map()
                    ply.write_ply(os.path.join(args.out_dir, args.map_ply), m_live)
                    print(f"[map] frame {i}: {len(m_live)} points -> {args.map_ply}",
                          file=sys.stderr)
                    next_map_stamp = stamp + 1.0 / cfg.map.publish_freq
            timing.push(runner.stats[-1].wall_ms if runner.stats else 0.0)
            if args.quiet:
                continue
            # distance tracking and health read the frame on the host; quiet
            # runs compute the distance once from the trajectory instead
            pos = runner.state.pose[:3, 3].cpu().numpy()
            if last_pos is not None:
                distance += float(np.linalg.norm(pos - last_pos))
            last_pos = pos
            if res is None:
                continue
            status = runner.health_check(res)
            if status != "ok":
                print(
                    f"[health] frame {i}: {status} (s2s_corr={int(res.s2s_num_corr)} "
                    f"s2m_corr={int(res.s2m_num_corr)} s2s_converged={res.s2s_converged})"
                    + (" — restart from --checkpoint to recover" if status == "diverged" else ""),
                    file=sys.stderr,
                )
            if i % args.dashboard_every == 0:
                health = {"s2s_it": res.s2s_iterations, "s2s_nc": int(res.s2s_num_corr),
                          "s2m_it": res.s2m_iterations, "s2m_nc": int(res.s2m_num_corr)}
                print(profiling.dashboard(i, pos, res.quat.cpu().numpy(), distance, timing,
                                          int(res.num_keyframes), health, cpu=cpu_mon))
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)

    # --- outputs ----------------------------------------------------------
    est = runner.trajectory()
    if args.quiet and len(est) > 1:
        distance = float(np.sum(np.linalg.norm(np.diff(est[:, :3, 3], axis=0), axis=-1)))
    trajectory.write_kitti(os.path.join(args.out_dir, args.traj_kitti), est)
    trajectory.write_tum(os.path.join(args.out_dir, args.traj_tum), np.asarray(runner.stamps), est)
    if args.map_ply and runner.state is not None:
        if cfg.map.carry_intensity and runner.has_intensity_map():
            m = runner.build_map_xyzi()  # [P, 4] xyzi
        else:
            m = runner.build_map()
        ply.write_ply(os.path.join(args.out_dir, args.map_ply), m)
        print(f"map: {len(m)} points -> {args.map_ply}", file=sys.stderr)
    if args.checkpoint and runner.state is not None:
        checkpoint.save_state(os.path.join(args.out_dir, args.checkpoint), runner.state,
                              extra={"prev_stamp": runner.prev_stamp})

    summary = {
        "frames": len(est),
        "keyframes": runner.num_keyframes(),
        "distance_m": round(distance, 2),
        **{k: round(v, 2) for k, v in timing.steady_state().items()},
    }
    if cfg.posegraph.use:
        summary.update(
            refine_rounds=len(runner.refine_log),
            loop_edges_accepted=sum(e["n_accepted"] for e in runner.refine_log),
        )
    if args.eval and gt_poses is not None and len(est) > 1:
        gt_rel = np.linalg.inv(gt_poses[0])[None] @ gt_poses[: len(est)]
        ate = evaluation.ate(est, gt_rel, align=False)
        rpe_t, rpe_r = evaluation.rpe(est, gt_rel)
        summary.update(
            ate_rmse_m=round(ate.rmse, 4), ate_max_m=round(ate.max, 4),
            rpe_trans_m=round(rpe_t, 4), rpe_rot_deg=round(rpe_r, 4),
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
