"""Per-frame health trace of the bench world.

Port of the JAX package's ``tools/trace_frames.py``.

    python3 tools_torch/trace_frames.py [world_frames] [run_frames] [--cpu] [key=val ...]

Runs the bench configuration (``bench_torch.production_cfg``) frame by
frame, each frame synced, on the card (``--cpu``: on the CPU), and prints
the position error against ground truth and the GICP health of every
frame. This is the trace that located the JAX package's
round-2 divergence: S2S stalled in a local minimum of the gated
plane-to-plane objective at production density and the tight 0.5 m S2M
gate could not pull it back, fixed by the staged-gate rescue
(``GicpConfig.s2m_rescue``). ``key=val`` overrides a config field
(dotted path, as the CLI's ``--set``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import make_bench_world, production_cfg, with_overrides  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device  # noqa: E402


def run(frames: int = 45, run_frames: int | None = None, device="cuda", overrides=(),
        small: bool = False) -> list[dict]:
    """Trace ``run_frames`` (default ``frames``) frames of a ``frames``-frame
    bench world. One row a frame: ``t``, ``err_cm`` (position error),
    ``ms`` (synced wall), and on stepped frames (``init`` False) the JAX
    tool's fields: ``s2s_it``, ``s2s_nc``, ``s2s_cv``, ``s2s_e``, the same
    four for ``s2m``, ``kf``, ``sp`` (spaciousness), ``th`` (keyframe
    distance threshold), ``chg`` (submap changed). ``overrides``:
    "key=val" strings."""
    dev = require_device(device)
    run_frames = frames if run_frames is None else run_frames
    cfg = with_overrides(production_cfg(small), overrides)
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(frames, rng, small)
    scans = [synthetic.render_scan(world, t, rng, beams=beams, max_range=max_range,
                                   max_points=max_pts) for t in range(run_frames)]
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses
    runner = OdometryRunner(cfg, device=dev)
    print(f"# device={dev.type} stride={cfg.gicp.s2s_coarse_stride} backend={cfg.nn_backend}",
          file=sys.stderr)
    rows = []
    for t in range(run_frames):
        t0 = time.perf_counter()
        res = runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
        ms = (time.perf_counter() - t0) * 1e3
        est = runner.poses[-1].cpu().numpy()
        row = {"t": t, "init": res is None,
               "err_cm": float(np.linalg.norm(est[:3, 3] - gt[t, :3, 3])) * 100, "ms": ms}
        if res is not None:
            row.update(
                s2s_it=int(res.s2s_iterations), s2s_nc=int(res.s2s_num_corr),
                s2s_cv=bool(res.s2s_converged), s2s_e=float(res.s2s_error),
                s2m_it=int(res.s2m_iterations), s2m_nc=int(res.s2m_num_corr),
                s2m_cv=bool(res.s2m_converged), s2m_e=float(res.s2m_error),
                kf=int(res.num_keyframes), sp=float(res.spaciousness),
                th=float(res.keyframe_thresh_dist), chg=bool(res.submap_changed))
        rows.append(row)
        print(format_row(row), flush=True)
    return rows


def format_row(r: dict) -> str:
    """The JAX tool's line for a row."""
    if r["init"]:
        return f"t={r['t']:3d} init err={r['err_cm']:7.2f}cm {r['ms']:7.1f}ms"
    return (f"t={r['t']:3d} err={r['err_cm']:7.2f}cm "
            f"s2s[it={r['s2s_it']:2d} nc={r['s2s_nc']:6d} cv={r['s2s_cv']} e={r['s2s_e']:9.1f}] "
            f"s2m[it={r['s2m_it']:2d} nc={r['s2m_nc']:6d} cv={r['s2m_cv']} e={r['s2m_e']:9.1f}] "
            f"kf={r['kf']} sp={r['sp']:5.2f} th={r['th']:4.1f} chg={r['chg']} {r['ms']:6.1f}ms")


def parse_argv(argv: list[str]) -> dict:
    """:func:`run`'s arguments from the JAX tool's argv."""
    argv = list(argv)
    device = "cuda"
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    frames = int(argv[0]) if argv else 45
    run_frames = frames
    if len(argv) > 1 and argv[1].isdigit():
        run_frames = int(argv.pop(1))
    return dict(frames=frames, run_frames=run_frames, device=device, overrides=argv[1:])


def main() -> None:
    run(**parse_argv(sys.argv[1:]))


if __name__ == "__main__":
    main()
