"""Chunked dispatch against per-frame dispatch: ATE by chunk size.

Port of the JAX package's ``tools/staleness_sweep.py``. There, the
``lax.scan`` chunk program holds the exact host hull masks constant for a
whole chunk, so submap selection may run on memberships up to K frames old,
and the sweep measures what K costs on a constantly turning closed loop.
In this port ``process_chunk`` is a host loop that keeps the masks exactly
one frame behind, as ``process_scan(sync=True)`` does, so every chunk size
must give the chunk-1 trajectory. The sweep checks that instead of
assuming it: each row carries its largest pose difference to the chunk-1
run.

On the card (production shapes):  SMALL=0 python3 tools_torch/staleness_sweep.py
Small shapes on the card:          python3 tools_torch/staleness_sweep.py
On the CPU, call :func:`run` with ``device="cpu"``.
Environment (the JAX tool's): ``SMALL`` (default 1), ``SS_FRAMES`` (96),
``SS_CHUNKS`` ("1,8,16,32"), ``STALE_SOUP``. Prints one JSON line per chunk
size.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import evaluation, synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from tools_torch.long_validation import SMALL_SHAPES, require_device  # noqa: E402

WARM = 2  # frames through process_scan before the chunks start


def make_config(small: bool = True) -> DloConfig:
    """Host preprocessing on, keyframes every 2 m (adaptive off), so hull
    membership changes within a chunk: the mechanism under test."""
    base = DloConfig().replace(s2s_prior="constant_velocity", host_preprocess=True)
    if small:
        base = base.replace(shapes=ShapeConfig(max_keyframes=24, **SMALL_SHAPES))
    base = dataclasses.replace(
        base,
        keyframe=dataclasses.replace(base.keyframe, thresh_dist=2.0),
        adaptive=dataclasses.replace(base.adaptive, use=False),
    )
    return base


def make_scans(frames: int, small: bool = True, soup: bool = False):
    """(world, scans): the ray-cast closed loop of ``frames`` frames
    (``rng(5)``, no moving boxes), or the legacy point-soup loop with
    ``soup``; scan t rendered with ``rng(100 + t)``."""
    rng = np.random.default_rng(5)
    if small:
        max_range, max_pts, speed = 13.0, SMALL_SHAPES["n_raw"], 0.4
    else:
        max_range, max_pts, speed = 40.0, ShapeConfig().n_raw, 1.0
    if soup:
        world = synthetic.make_loop_world(
            rng, n_frames=frames, speed=speed, z_amplitude=1.0,
            density=25.0 if not small else 6.0, ground_density=25.0 if not small else 9.0)
        beams = None
    else:
        # the loop radius speed * frames / (2 pi) must clear the corridor
        # offset, or inner-side buildings crowd the loop centre
        speed = max(speed, 2 * np.pi * 11.0 / frames) if small else speed
        world = synthetic.make_urban_world(
            rng, n_frames=frames, speed=speed, closed_loop=True, z_amplitude=1.0, n_dynamic=0,
            corridor=7.0 if small else 14.0)
        beams = synthetic.BeamModel(n_beams=32, n_azimuth=512) if small else synthetic.BeamModel()
    scans = [synthetic.render_scan(world, t, np.random.default_rng(100 + t), max_range=max_range,
                                   max_points=max_pts, beams=beams)
             for t in range(frames)]
    return world, scans


def drive_chunked(cfg: DloConfig, world, scans, chunk: int, device="cuda") -> OdometryRunner:
    """WARM frames through ``process_scan(sync=True)``, then the rest in
    chunks of ``chunk`` through ``process_chunk`` (chunk 1: through
    ``process_scan(sync=True)``, the per-frame reference the chunks must
    equal). Returns the runner."""
    runner = OdometryRunner(cfg, device=device)
    n = len(scans)
    for t in range(min(WARM, n)):
        runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
    t = WARM
    while t < n:
        k = min(chunk, n - t)
        if k > 1:
            runner.process_chunk(scans[t: t + k], [float(s) for s in world.stamps[t: t + k]])
        else:
            runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
        t += k
    return runner


def sweep(cfg: DloConfig, world, scans, chunks, device="cuda") -> list[dict]:
    """One row per chunk size: the JAX tool's keys (``chunk``, ``frames``,
    ``ate_rmse_m``, ``ate_max_m``, ``keyframes``), ``max_dev_vs_chunk1_m``
    (the largest position difference to the chunk-1 trajectory, driven
    first as the reference whether or not 1 is in ``chunks``) and
    ``same_as_chunk1`` (the two trajectories bit for bit)."""
    frames = len(scans)
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses
    runs = {}  # chunk -> (trajectory, keyframes)
    for chunk in (1, *(c for c in chunks if c != 1)):
        runner = drive_chunked(cfg, world, scans, chunk, device)
        runs[chunk] = runner.trajectory(), runner.num_keyframes()
    ref = runs[1][0]
    rows = []
    for chunk in chunks:
        est, n_kf = runs[chunk]
        ate = evaluation.ate(est, gt[: len(est)], align=False)
        rows.append({
            "chunk": chunk, "frames": frames,
            "ate_rmse_m": float(ate.rmse), "ate_max_m": float(ate.max),
            "keyframes": n_kf,
            "max_dev_vs_chunk1_m": float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max()),
            "same_as_chunk1": bool(np.array_equal(est, ref)),
        })
    return rows


def run(device="cuda", small: bool = True, frames: int = 96, chunks=(1, 8, 16, 32),
        soup: bool = False) -> list[dict]:
    """The JAX tool's sweep (:func:`sweep`) on its configuration and world."""
    require_device(device)
    world, scans = make_scans(frames, small, soup)
    return sweep(make_config(small), world, scans, chunks, device)


def env_args() -> dict:
    return dict(
        small=bool(int(os.environ.get("SMALL", "1"))),
        frames=int(os.environ.get("SS_FRAMES", "96")),
        chunks=[int(c) for c in os.environ.get("SS_CHUNKS", "1,8,16,32").split(",")],
        soup=bool(int(os.environ.get("STALE_SOUP", "0"))),
    )


def main() -> None:
    for row in run(device="cuda", **env_args()):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
