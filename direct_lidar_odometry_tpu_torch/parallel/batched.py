"""Multi-sequence batched odometry: the throughput axis.

Counterpart of the JAX package's ``parallel/batched.py``. Odometry is
sequential in time, so the way to give one card more work is to run
independent sequences side by side. The JAX package ``vmap``s its pure
per-frame step; here the step has a batched twin
(``pipeline.odom_frame_batched``) that carries a leading lane dimension
through every stage, on every backend: it launches each kernel (K1
normals, K2/K4 searches or the fused K3) once for all lanes, and on
"brute" and "hashgrid" runs each tensor-op search (and builds each hash
grid) once for all lanes. Host reads per step do not grow with B: each
GICP inner iteration reads one [2, B] flag tensor and each branch one [B]
tensor.

Semantics (those of ``jax.vmap`` over the JAX step): every lane equals its
own single-sequence ``pipeline.odom_frame`` driven directly with
``hull_masks=None``, the device hull surrogates, as the JAX package's
batched and sharded paths use them. Host preprocessing is forced off, so
callers feed raw scans.
"""

from __future__ import annotations

from typing import Callable

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline
from direct_lidar_odometry_tpu_torch.odometry.state import OdomState
from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32


def batched_state(cfg: DloConfig, batch: int, device="cuda") -> OdomState:
    """``batch`` fresh per-sequence states stacked along a leading lane
    dimension: every tensor, the keyframe ring, the submap cache and the
    hash grid ("hashgrid" only; its ``cell_size`` becomes [batch])
    included, gets a leading [batch]; each lane is a copy of
    ``pipeline.fresh_state``."""
    one = pipeline.fresh_state(cfg, device=device)

    def stack(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return type(v)(*(stack(t) for t in v))
        return v.expand((batch,) + v.shape).clone()

    return stack(one)


def make_batched_fns(cfg: DloConfig) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) over a leading sequence axis.

    init_fn(states[B], raw_points[B,N,3], raw_mask[B,N]) -> states
    step_fn(states, raw_points, raw_mask, imu_priors[B,4,4])
        -> (states, FrameResult[B])

    Both run on the device of ``states``, on every backend. A state passed
    in is consumed (its ring, submap cache and hash grid are written in
    place), as in the single-sequence step.
    """
    cfg = cfg.replace(host_preprocess=False)
    pin_float32()
    fib = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions))
    directions = {}

    def init_fn(states: OdomState, raw_points: torch.Tensor, raw_mask: torch.Tensor):
        return pipeline.init_frame(cfg, states, raw_points, raw_mask)

    def step_fn(states: OdomState, raw_points: torch.Tensor, raw_mask: torch.Tensor,
                imu_priors: torch.Tensor):
        dev = states.pose.device
        if dev not in directions:
            directions[dev] = fib.to(dev)
        return pipeline.odom_frame_batched(cfg, directions[dev], states, raw_points, raw_mask,
                                           imu_priors)

    return init_fn, step_fn
