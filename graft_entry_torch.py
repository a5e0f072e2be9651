"""Entry points of the PyTorch port: a single-device step check and a
multi-device dry run.

Torch twin of ``__graft_entry__.py`` (which stays the JAX package's):

- ``entry(device)`` returns the per-frame odometry step (preprocess + S2S
  GICP + submap + S2M GICP + keyframing, ``pipeline.odom_frame``) with its
  example arguments, the state after the first frame;
- ``dryrun_multichip(n, device)`` runs ONE step of the sharded batched
  odometry step over ``n`` lanes (one sequence a rank: the ``seq`` axis)
  and one distributed pose-graph refinement (the edges split over the
  ranks, H, b and the error summed) on a group of ``n`` processes, on tiny
  shapes. On the card the group is NCCL with one process a card (``n`` <=
  the card count); on "cpu" it is ``n`` gloo processes. ``n`` = 1 runs in
  this process. Every group it opens is destroyed before it returns.

    python3 graft_entry_torch.py      # on the card: entry, then the dry run on every card
"""

from __future__ import annotations

import os
import sys
import tempfile
from functools import partial

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def _tiny_cfg():
    from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig

    return DloConfig().replace(
        shapes=ShapeConfig(
            n_raw=2048,
            n_scan=2048,
            n_keyframe=1024,
            max_keyframes=16,
            max_submap_kf=4,
            imu_window=32,
            grid_table_size=2 ** 12,
            submap_table_size=2 ** 12,
            cell_cap_1nn=8,
            cell_cap_knn=32,
            knn_query_chunk=1024,
            hull_directions=16,
        )
    )


def _example_inputs(cfg, batch=None, device="cuda"):
    """Uniform points from ``rng(0)``, an all-true mask and the identity
    prior, on ``device``; with ``batch``, the same for every lane."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, size=(cfg.shapes.n_raw, 3)).astype(np.float32)
    mask = np.ones((cfg.shapes.n_raw,), bool)
    eye = np.eye(4, dtype=np.float32)
    if batch is not None:
        pts = np.broadcast_to(pts, (batch,) + pts.shape).copy()
        mask = np.broadcast_to(mask, (batch,) + mask.shape).copy()
        eye = np.broadcast_to(eye, (batch, 4, 4)).copy()
    return tuple(torch.from_numpy(a).to(device) for a in (pts, mask, eye))


def entry(device="cuda"):
    """(step, example_args): ``step(*args)`` runs one frame of
    ``pipeline.odom_frame`` on the state that ``init_frame`` made from the
    example scan."""
    from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline
    from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device

    dev = require_device(device)
    cfg = _tiny_cfg()
    directions = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions)).to(dev)
    state = pipeline.fresh_state(cfg, device=dev)
    pts, mask, prior = _example_inputs(cfg, device=dev)
    state = pipeline.init_frame(cfg, state, pts, mask)
    return partial(pipeline.odom_frame, cfg, directions), (state, pts, mask, prior)


def _dryrun_rank(rank: int, n_devices: int, init_method: str, device: str) -> None:
    """One rank of the dry run (see the module docstring)."""
    import torch.distributed as dist

    from direct_lidar_odometry_tpu_torch.parallel import batched, posegraph, sharded

    if device == "cpu" and n_devices > 1:
        torch.set_num_threads(1)  # the ranks share the machine's cores
    sharded.init_distributed(init_method, n_devices, rank, device=device)
    try:
        cfg = _tiny_cfg()
        mesh = sharded.make_mesh(n_devices, device=device)

        # --- sharded multi-sequence odometry step (one lane a rank) ---
        init_fn, _ = batched.make_batched_fns(cfg)
        pts, mask, prior = sharded.shard_states(
            _example_inputs(cfg, batch=n_devices, device=mesh.device), mesh)
        states = init_fn(sharded.shard_states(batched.batched_state(cfg, n_devices, mesh.device),
                                              mesh), pts, mask)
        step = sharded.make_sharded_step(cfg, mesh)
        states, res, mean_corr, max_err = step(states, pts, mask, prior)
        # this rank's share of the [n_devices, 3] positions
        assert res.position.shape == (n_devices // mesh.size, 3)
        assert np.isfinite(float(mean_corr))

        # --- distributed pose-graph refinement (edges split over the ranks) ---
        k = 8
        m = 2 * n_devices  # divisible by the group
        rng = np.random.default_rng(0)
        positions = torch.from_numpy(
            np.cumsum(rng.normal(scale=0.5, size=(k, 3)), axis=0).astype(np.float32)).to(mesh.device)
        quats = torch.tensor([1.0, 0, 0, 0], device=mesh.device).repeat(k, 1)
        graph = posegraph.odometry_chain_graph(positions, quats, torch.tensor(k, device=mesh.device),
                                               max_edges=m)
        refine = sharded.make_distributed_refine(mesh, iterations=2)
        poses, err = refine(graph)
        assert poses.shape == (k, 4, 4)
        assert np.isfinite(float(err))
        sharded.barrier("dryrun")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Execute the sharded batched step and the distributed pose-graph
    refinement on a group of ``n_devices`` processes (a file store in a
    temporary directory joins them)."""
    from direct_lidar_odometry_tpu_torch.parallel.sharded import require_device
    from tools_torch.scaling_procs import run_ranks

    kind = require_device(device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="dryrun_store_") as tmp:
        init_method = f"file://{tmp}/store"
        if n_devices == 1:
            _dryrun_rank(0, 1, init_method, kind)
            return
        env = dict(os.environ, PYTHONPATH=REPO)
        if kind == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        run_ranks([[sys.executable, "-c", f"from graft_entry_torch import _dryrun_rank; "
                                          f"_dryrun_rank({rank}, {n_devices}, {init_method!r}, "
                                          f"{kind!r})"] for rank in range(n_devices)],
                  env, timeout=600)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK")
    dryrun_multichip(min(8, torch.cuda.device_count()))
    print("dryrun_multichip OK")
