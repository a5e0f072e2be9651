"""Weak scaling of the sharded multi-sequence step over N processes.

Port of the JAX package's ``tools/scaling_bench.py``: the sharded step
(``parallel/sharded.py``) at N = 1, 2, 4, 8 with a FIXED batch per device
(``SCALING_BATCH`` sequences; more devices, more sequences), efficiency(N)
= fps(N) / (N fps(1)). torch has no in-process virtual mesh, so N devices
are N processes joined by ``sharded.init_distributed``: on the card one
process a card over NCCL (one H100 gives N = 1), with
``SCALING_PLATFORM=cpu`` N gloo processes each pinned to one core
(``tools_torch/scaling_procs.py``'s layout); more processes than cards or
cores raises.

On the card:  python3 tools_torch/scaling_bench.py
On the CPU:   SCALING_PLATFORM=cpu SCALING_SIZES=1,2 python3 tools_torch/scaling_bench.py

Environment (the JAX tool's): ``SCALING_PLATFORM`` ("cpu" for the CPU,
else the card), ``SCALING_BATCH`` (2), ``SCALING_FRAMES`` (10: frame 0
initializes, frame 1 warms up, the rest are timed), ``SCALING_SIZES``
(e.g. "1,2"; default every N of 1, 2, 4, 8 up to the cards or cores).
Prints one JSON line per N (``devices``, ``batch``, ``ms_per_step``, the
median synced step, ``aggregate_fps``, ``iter_skew_frac_mean`` / ``_max``:
the spread of the per-device S2S + S2M iteration totals over their mean,
which bounds the work imbalance a sharded step waits for) and the
``scaling_efficiency`` table, unrounded.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.io import synthetic  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel import batched, sharded  # noqa: E402
from tools_torch import scaling_procs  # noqa: E402


def make_config(device: str = "cuda") -> DloConfig:
    """The JAX tool's configuration; "hashgrid" on the CPU, as the JAX
    package's "auto" resolves there (``scaling_procs_worker.make_config``)."""
    return DloConfig().replace(
        nn_backend="hashgrid" if device == "cpu" else "auto",
        quantize_transfer=False,
        s2s_prior="constant_velocity",
        shapes=ShapeConfig(
            n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=64, max_submap_kf=8,
            imu_window=64, grid_table_size=2 ** 14, submap_table_size=2 ** 15, cell_cap_1nn=16,
            cell_cap_knn=48, knn_query_chunk=2048, hull_directions=32),
    )


def make_world(frames: int):
    """The JAX tool's wandering world, ``rng(0)``."""
    return synthetic.make_world(np.random.default_rng(0), n_frames=frames, extent=15.0,
                                n_boxes=6, speed=0.4, ground_points=8000, density=6.0)


def scans_for(world, n_raw: int, lanes: range, t: int) -> tuple[np.ndarray, np.ndarray]:
    """Frame ``t`` of sequences ``lanes``: sequence i's scan is
    ``render_scan(world, t, rng(100 + i))``, padded to ``n_raw``."""
    pts = np.full((len(lanes), n_raw, 3), 1e6, np.float32)
    mask = np.zeros((len(lanes), n_raw), bool)
    for row, i in enumerate(lanes):
        s = synthetic.render_scan(world, t, np.random.default_rng(100 + i), max_range=13.0,
                                  max_points=8192)
        pts[row, :len(s)] = s
        mask[row, :len(s)] = True
    return pts, mask


def worker(rank: int, n: int, port: int, device: str, per_device: int, frames: int) -> None:
    """One rank of an ``n``-process group: its ``per_device`` sequences
    through the sharded step; rank 0 prints the row as its last line."""
    if device == "cpu":
        torch.set_num_threads(1)  # one pinned core a process
    sharded.init_distributed(f"127.0.0.1:{port}", n, rank, device=device)
    try:
        mesh = sharded.make_mesh(n, device=device)
        dev = mesh.device
        cfg = make_config(device)
        world = make_world(frames)
        lanes = range(rank * per_device, (rank + 1) * per_device)

        def frame(t):
            return tuple(torch.from_numpy(a).to(dev) for a in
                         scans_for(world, cfg.shapes.n_raw, lanes, t))

        init_fn, _ = batched.make_batched_fns(cfg)
        step = sharded.make_sharded_step(cfg, mesh)
        eye = torch.eye(4, device=dev).expand(per_device, 4, 4).clone()
        states = init_fn(batched.batched_state(cfg, per_device, dev), *frame(0))
        states, res, _, _ = step(states, *frame(1), eye)  # warm-up
        res.position.cpu()
        sharded.barrier("warm")
        times, skews = [], []
        for t in range(2, frames):
            pts, mask = frame(t)
            t0 = time.perf_counter()
            states, res, _, _ = step(states, pts, mask, eye)
            res.position.cpu()
            times.append(time.perf_counter() - t0)
            # a sharded step ends with its slowest rank: the spread of the
            # ranks' iteration totals bounds the imbalance it waits for
            it = torch.sum(res.s2s_iterations.to(torch.float64)
                           + res.s2m_iterations.to(torch.float64)).reshape(1)
            per_dev = [torch.zeros_like(it) for _ in range(n)]
            torch.distributed.all_gather(per_dev, it, group=mesh.group)
            per_dev = torch.cat(per_dev).cpu().numpy()
            skews.append((per_dev.max() - per_dev.min()) / max(per_dev.mean(), 1e-9))
        sharded.barrier("timed")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if rank == 0:
        med = float(np.median(times))
        b = per_device * n
        print(json.dumps({
            "devices": n, "batch": b, "ms_per_step": med * 1e3, "aggregate_fps": b / med,
            "iter_skew_frac_mean": float(np.mean(skews)),
            "iter_skew_frac_max": float(np.max(skews)),
        }), flush=True)


def available(device) -> int:
    """Cards, or the cores this process may run on."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return len(os.sched_getaffinity(0))


def run(per_device: int = 2, frames: int = 10, sizes: list[int] | None = None,
        device="cuda") -> list[dict]:
    """One row per N of ``sizes`` (default: 1, 2, 4, 8 up to
    :func:`available`), then the ``scaling_efficiency`` summary."""
    kind = sharded.require_device(device).type
    if frames < 3:
        raise ValueError(f"SCALING_FRAMES={frames}: frame 0 initializes, 1 warms up, "
                         "at least one more is timed")
    if sizes is None:
        sizes = [n for n in (1, 2, 4, 8) if n <= available(kind)]
    rows = []
    for n in sizes:
        prefix, env = scaling_procs.rank_layout(n, kind)
        port = scaling_procs.free_port()
        call = (f"from tools_torch.scaling_bench import worker; "
                f"worker({{rank}}, {n}, {port}, {kind!r}, {per_device}, {frames})")
        cmds = [pre + [sys.executable, "-c", call.format(rank=rank)]
                for rank, pre in enumerate(prefix)]
        out = scaling_procs.run_ranks(cmds, env)[0]
        rows.append(json.loads(out.strip().splitlines()[-1]))
    base = rows[0]["aggregate_fps"]
    rows.append({
        "metric": "scaling_efficiency",
        "table": [{"devices": r["devices"], "aggregate_fps": r["aggregate_fps"],
                   "efficiency": r["aggregate_fps"] / (r["devices"] * base)} for r in rows],
    })
    return rows


def env_args() -> dict:
    """:func:`run`'s arguments from the JAX tool's environment variables."""
    sizes = os.environ.get("SCALING_SIZES")
    return dict(
        per_device=int(os.environ.get("SCALING_BATCH", "2")),
        frames=int(os.environ.get("SCALING_FRAMES", "10")),
        sizes=[int(s) for s in sizes.split(",")] if sizes else None,
        device="cpu" if os.environ.get("SCALING_PLATFORM") == "cpu" else "cuda",
    )


def main() -> None:
    args = env_args()
    print(f"# devices available: {available(args['device'])} ({args['device']})",
          file=sys.stderr)
    for row in run(**args):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
