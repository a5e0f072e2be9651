"""What the device hull surrogate costs end to end: exact host hulls
against the surrogate against the batched step.

Port of the JAX package's ``tools/hull_ab.py``. The single-sequence runner
feeds exact QHull membership masks (computed on the host one frame behind,
``odometry/hosthull.py``); the batched and sharded paths use the device's
direction-extremal surrogate (``odometry/hulls.py``). The same world is
driven through (a) the runner with exact hulls, (b) the runner with the
host hull feed turned off (surrogate), and (c) ``make_batched_fns`` at B
lanes (surrogate by construction; lane i renders with
``rng(1000 + t + 7919 i)``, so lane 0 sees (a)'s and (b)'s scans). The
configuration makes the hulls matter: keyframes every 1 m and a submap of
3 + 3 + 3 keyframes. This port also drives lane 0's scans through the
single-sequence step with the surrogate (``odom_frame(hull_masks=None)``,
the batched path's float input) and reports lane 0's largest difference
to it, which must be 0.

On the card:  python3 tools_torch/hull_ab.py
On the CPU, call :func:`run` with ``device="cpu"``.
Environment (the JAX tool's): ``HAB_FRAMES`` (60), ``HAB_BATCH`` (4),
``HULL_SOUP``. Prints one JSON line per configuration.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.core.cloud import PAD_VALUE  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import evaluation, synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel import batched  # noqa: E402
from tools_torch.long_validation import SMALL_SHAPES, require_device  # noqa: E402

MAX_RANGE = 13.0
LANE_SEED_STRIDE = 7919


def make_config() -> DloConfig:
    base = DloConfig().replace(s2s_prior="constant_velocity")
    base = base.replace(
        shapes=ShapeConfig(max_keyframes=24, **SMALL_SHAPES),
        # many keyframes and a small submap.knn make the hull-selected
        # keyframes a real part of the submap
        keyframe=dataclasses.replace(base.keyframe, thresh_dist=1.0),
        adaptive=dataclasses.replace(base.adaptive, use=False),
        submap=dataclasses.replace(base.submap, knn=3, kcv=3, kcc=3),
    )
    return base


def make_world(frames: int, soup: bool = False):
    """(world, beams): a wandering ray-cast corridor (``rng(9)``; a closed
    loop of 60 frames at 0.4 m a frame is too tight for 13 m scans), or
    the legacy point-soup loop with ``soup``."""
    rng = np.random.default_rng(9)
    if soup:
        world = synthetic.make_loop_world(rng, n_frames=frames, speed=0.4, z_amplitude=1.0,
                                          density=6.0, ground_density=9.0)
        return world, None
    world = synthetic.make_urban_world(rng, n_frames=frames, speed=0.4, corridor=7.0, n_dynamic=0)
    return world, synthetic.BeamModel(n_beams=32, n_azimuth=512)


def render(world, beams, t: int, lane: int = 0) -> np.ndarray:
    return synthetic.render_scan(world, t, np.random.default_rng(1000 + t + LANE_SEED_STRIDE * lane),
                                 max_range=MAX_RANGE, max_points=SMALL_SHAPES["n_raw"], beams=beams)


def ate_row(est: np.ndarray, gt: np.ndarray):
    return evaluation.ate(est, gt[: len(est)], align=False)


def run_single(cfg: DloConfig, world, beams, exact_hulls: bool, device="cuda") -> dict:
    runner = OdometryRunner(cfg, device=device)
    if not exact_hulls:
        # no host hull feed: the masks stay all-False with hull_fresh False,
        # so submap selection falls back to the device surrogate, as batched
        runner._enqueue_hull_fetch = lambda *_a, **_k: None
    for t in range(len(world.poses)):
        runner.process_scan(render(world, beams, t), float(world.stamps[t]), sync=True)
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses
    ate = ate_row(runner.trajectory()[: len(gt)], gt)
    return {"config": "single_exact_hulls" if exact_hulls else "single_surrogate_hulls",
            "frames": len(world.poses), "ate_rmse_m": float(ate.rmse), "ate_max_m": float(ate.max),
            "keyframes": runner.num_keyframes()}


def lane_frames(cfg: DloConfig, world, beams, b: int, dev) -> list:
    """[T] of (points [b, n_raw, 3], mask [b, n_raw]) on ``dev``."""
    n = cfg.shapes.n_raw
    out = []
    for t in range(len(world.poses)):
        pts = np.full((b, n, 3), PAD_VALUE, np.float32)
        mask = np.zeros((b, n), bool)
        for i in range(b):
            s = render(world, beams, t, i)[:n]
            pts[i, : len(s)] = s
            mask[i, : len(s)] = True
        out.append((torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)))
    return out


def surrogate_drive(cfg: DloConfig, frames: list, lane: int = 0) -> np.ndarray:
    """Lane ``lane`` of ``frames`` through the single-sequence step with the
    device surrogate (``odom_frame(hull_masks=None)``): poses [T, 4, 4]."""
    dev = frames[0][0].device
    directions = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions)).to(dev)
    st = pipeline.init_frame(cfg, pipeline.fresh_state(cfg, device=dev), frames[0][0][lane],
                             frames[0][1][lane])
    poses = [torch.eye(4, device=dev)]
    eye = torch.eye(4, device=dev)
    for pts, mask in frames[1:]:
        st, res = pipeline.odom_frame(cfg, directions, st, pts[lane], mask[lane], eye,
                                      hull_masks=None)
        poses.append(res.pose)
    return torch.stack(poses).cpu().numpy()


def run_batched(cfg: DloConfig, world, beams, b: int, device="cuda") -> dict:
    dev = require_device(device)
    cfg = cfg.replace(host_preprocess=False)
    frames = lane_frames(cfg, world, beams, b, dev)
    init_fn, step_fn = batched.make_batched_fns(cfg)
    states = init_fn(batched.batched_state(cfg, b, dev), *frames[0])
    eye = torch.eye(4, device=dev).expand(b, 4, 4).clone()
    poses = [torch.eye(4, device=dev).expand(b, 4, 4)]
    for pts, mask in frames[1:]:
        states, res = step_fn(states, pts, mask, eye)
        poses.append(res.pose)
    lanes = torch.stack(poses).cpu().numpy()  # [T, b, 4, 4]
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses
    ates = [float(ate_row(lanes[:, i], gt).rmse) for i in range(b)]
    single = surrogate_drive(cfg, frames)
    return {"config": "batched_surrogate_hulls", "frames": len(world.poses), "batch": b,
            "ate_rmse_m_per_seq": ates, "ate_rmse_m_mean": float(np.mean(ates)),
            "lane0_vs_single_surrogate_max_m": float(np.abs(lanes[:, 0] - single).max())}


def run(device="cuda", frames: int = 60, batch: int = 4, soup: bool = False) -> list[dict]:
    """The JAX tool's three rows (``config`` = "single_exact_hulls",
    "single_surrogate_hulls", "batched_surrogate_hulls", under its keys);
    the batched row also has ``lane0_vs_single_surrogate_max_m``."""
    require_device(device)
    cfg = make_config()
    world, beams = make_world(frames, soup)
    return [run_single(cfg, world, beams, True, device),
            run_single(cfg, world, beams, False, device),
            run_batched(cfg, world, beams, batch, device)]


def env_args() -> dict:
    return dict(frames=int(os.environ.get("HAB_FRAMES", "60")),
                batch=int(os.environ.get("HAB_BATCH", "4")),
                soup=bool(int(os.environ.get("HULL_SOUP", "0"))))


def main() -> None:
    for row in run(device="cuda", **env_args()):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
