"""Multi-process sharding over ``torch.distributed``: multi-sequence
odometry and distributed pose-graph refinement.

Counterpart of the JAX package's ``parallel/sharded.py``, which lays a
``seq`` (or ``edge``) mesh axis over devices with ``shard_map``. Here the
mesh is the process group: one process per card (NCCL) or per CPU worker
(gloo), each holding its shard.

- :func:`init_distributed` joins the group on the asked device, NCCL for
  "cuda" and gloo for "cpu" (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE`` and ``RANK`` when no arguments are given); a single
  process without them runs locally, with no group;
- :func:`make_mesh` describes the group (size, rank, device), or alone a
  mesh of one on the asked device. Neither picks the CPU by itself:
  "cuda", the default, raises without a card;
- :func:`shard_states` keeps this rank's ``B / world`` lanes of a batched
  state or of any batched tensor;
- :func:`make_sharded_step` is the batched step on the local lanes
  (``parallel/batched.py``, every backend), then the fleet health: the global mean S2M
  correspondence count (SUM of the count's sum and of the lanes) and the
  global max S2M error (MAX), reduced on the device, with no host read;
- :func:`make_distributed_refine` splits the pose graph's edges over the
  ranks and sums H, b and the error over the group before the replicated
  solve (``posegraph.refine(group=...)``).

Odometry frames are independent across sequences, so the step itself needs
no collective; sharding the lanes is pure data parallelism.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from direct_lidar_odometry_tpu_torch.config import DloConfig
from direct_lidar_odometry_tpu_torch.parallel import batched, posegraph


class Mesh(NamedTuple):
    """This process's place in the group: ``size`` ranks, this one
    ``rank``, its ``device``; ``group`` is None when running alone."""

    size: int
    rank: int
    device: torch.device
    group: object | None


def require_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises (no
    silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available")
    return device


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Join the process group on ``device``: NCCL for "cuda" (one process
    a card, this one on card ``rank % count``; raises without a card),
    gloo for "cpu". ``coordinator`` is an init-method URL
    (``tcp://host:port``, ``file:///path``) or ``host:port``; without
    arguments torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` are used. A no-op when a group is already initialized, and
    when there is neither an argument nor the environment (a single
    process runs locally, with no group)."""
    device = require_device(device)
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None:
        return
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator, world_size=world, rank=rank)


def barrier(name: str = "", timeout_s: float = 600.0) -> None:
    """Align every rank (e.g. after each has built its kernels, before the
    first collective). A no-op without a group. ``name`` labels the call
    site only; ``timeout_s`` bounds a gloo group's wait
    (``monitored_barrier``), an NCCL group waits on its own timeout."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.monitored_barrier(timeout=timedelta(seconds=timeout_s))


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The group as a one-axis mesh: every rank of it, each on its own
    card under NCCL (or the CPU under gloo; ``device`` must name the
    group's kind); alone, a mesh of one on ``device`` ("cuda" raises
    without a card). ``n_devices`` must equal the group's size when
    given."""
    device = require_device(device)
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        nccl = dist.get_backend() == "nccl"
        if nccl != (device.type == "cuda"):
            raise ValueError(f"a {dist.get_backend()} group has no mesh on {str(device)!r}")
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else device
        group = dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} needs a group of that size; it has {size}")
    return Mesh(size=size, rank=rank, device=device, group=group)


def shard_states(states, mesh: Mesh):
    """A copy of this rank's ``B / size`` lanes of a batched state, on its
    device: of every tensor its contiguous share of the leading dimension
    (a tuple or NamedTuple field by field, the hash grid's leaves and its
    [B] ``cell_size`` included, None kept), so also of the scans
    of a step or of a pose graph's edges. B must divide by the group's
    size, as the JAX package's mesh requires."""
    if states is None:
        return None
    if isinstance(states, tuple):
        parts = [shard_states(v, mesh) for v in states]
        return type(states)(*parts) if hasattr(states, "_fields") else tuple(parts)
    total = states.shape[0]
    if total % mesh.size:
        raise ValueError(f"a leading dimension of {total} does not split over {mesh.size} ranks")
    share = total // mesh.size
    return states[mesh.rank * share:(mesh.rank + 1) * share].to(mesh.device, copy=True)


def make_sharded_step(cfg: DloConfig, mesh: Mesh) -> Callable:
    """The batched step on this rank's lanes, then the fleet health.

    step(states[B/size], raw_points, raw_mask, imu) -> (states, FrameResult,
    mean_corr, max_err): the local lanes' step (``make_batched_fns``), then
    ``mean_corr`` = the S2M correspondences summed over every lane of every
    rank over the lanes' count, and ``max_err`` = the largest S2M error of
    any lane; both are 0-d device tensors, equal on every rank, reduced by
    ``all_reduce`` on the device without a host read.
    """
    _, local_step = batched.make_batched_fns(cfg)

    def step(states, raw_points, raw_mask, imu_priors):
        states, res = local_step(states, raw_points, raw_mask, imu_priors)
        total = torch.sum(res.s2m_num_corr.to(torch.float32))
        lanes = torch.full((), float(res.s2m_num_corr.shape[0]), dtype=torch.float32,
                           device=total.device)
        max_err = torch.amax(res.s2m_error)
        if mesh.group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
            dist.all_reduce(lanes, op=dist.ReduceOp.SUM, group=mesh.group)
            dist.all_reduce(max_err, op=dist.ReduceOp.MAX, group=mesh.group)
        return states, res, total / lanes, max_err

    return step


def make_distributed_refine(mesh: Mesh, iterations: int = 5) -> Callable:
    """Pose-graph refinement with the edges split over the ranks.

    refine(graph) -> (poses, error): ``graph`` is the whole graph (the same
    on every rank); each rank keeps its contiguous share of the edges
    (their count must divide by the group's size), and H, b and the error
    are summed over the group before each replicated solve. The poses come
    back replicated."""

    def refine(graph: posegraph.PoseGraph):
        edges = shard_states((graph.edges, graph.rel, graph.edge_mask, graph.weights), mesh)
        local = graph._replace(poses=graph.poses.to(mesh.device),
                               pose_mask=graph.pose_mask.to(mesh.device),
                               **dict(zip(("edges", "rel", "edge_mask", "weights"), edges)))
        return posegraph.refine(local, iterations=iterations, group=mesh.group)

    return refine
