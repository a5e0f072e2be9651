"""Worker of the cross-process scaling harness (``tools_torch/scaling_procs.py``).

Port of the JAX package's ``tools/scaling_procs_worker.py``. Launched as

    python tools_torch/scaling_procs_worker.py <rank> <nprocs> <port> <steps> <device>

One rank of an ``nprocs`` group joined by ``sharded.init_distributed`` on
127.0.0.1:<port> (gloo on "cpu", one process a core; NCCL on "cuda", one
process a card). Each process owns ONE sequence of the batch axis and runs
the sharded multi-sequence step (``sharded.make_sharded_step``) at the
JAX worker's shapes: a warm-up step, a barrier, ``steps`` timed steps, a
barrier. Prints ``WORKER_FPS rank=<r> agg_fps=<fps> wall=<s>``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel import batched, sharded  # noqa: E402


def make_config(device: str = "cuda") -> DloConfig:
    """The JAX worker's configuration. Its "auto" backend is "hashgrid" on
    the CPU in the JAX package and "pallas" in the port; on the CPU the
    port's "pallas" runs the kernels' plain versions (tens of seconds a
    step here), so the CPU layout runs "hashgrid", as the JAX tool did."""
    return DloConfig().replace(nn_backend="hashgrid" if device == "cpu" else "auto", shapes=ShapeConfig(
        n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=32, max_submap_kf=8,
        imu_window=32, grid_table_size=2 ** 14, submap_table_size=2 ** 15, cell_cap_1nn=16,
        cell_cap_knn=48, knn_query_chunk=2048, hull_directions=16))


def main(rank: int, nprocs: int, port: str, steps: int, device: str = "cuda") -> float:
    """One rank's timed steps; returns (and prints) the aggregate fps."""
    if device == "cpu":
        torch.set_num_threads(1)  # one pinned core a process
    sharded.init_distributed(f"127.0.0.1:{port}", nprocs, rank, device=device)
    try:
        mesh = sharded.make_mesh(nprocs, device=device)
        cfg = make_config(device)
        b = nprocs  # one sequence per process
        rng = np.random.default_rng(0)
        pts0 = rng.uniform(-10, 10, size=(b, cfg.shapes.n_raw, 3)).astype(np.float32)
        pts1 = pts0 + np.array([0.2, 0.1, 0.0], np.float32)
        mask = np.ones((b, cfg.shapes.n_raw), bool)
        eye = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        local = [sharded.shard_states(torch.from_numpy(a), mesh) for a in (pts0, pts1, mask, eye)]
        pts0_l, pts1_l, mask_l, eye_l = local

        init_fn, _ = batched.make_batched_fns(cfg)
        states = init_fn(sharded.shard_states(batched.batched_state(cfg, b, mesh.device), mesh),
                         pts0_l, mask_l)
        step = sharded.make_sharded_step(cfg, mesh)
        states, res, _, _ = step(states, pts1_l, mask_l, eye_l)  # warm-up
        res.position.cpu()
        sharded.barrier("compiled")
        t0 = time.perf_counter()
        for _ in range(steps):
            states, res, _, _ = step(states, pts1_l, mask_l, eye_l)
        res.position.cpu()
        wall = time.perf_counter() - t0
        sharded.barrier("timed")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    agg_fps = b * steps / wall
    print(f"WORKER_FPS rank={rank} agg_fps={agg_fps} wall={wall}", flush=True)
    return agg_fps


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5])
