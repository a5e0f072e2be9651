"""Host-side sequence runner, per-frame path.

Counterpart of the JAX package's ``odometry/runner.py`` (the reference's
process shell, ``odom_node.cc``, ``odom.cc:586-697``): a Python loop that
encodes each scan, feeds it to the per-frame step on ``device`` and
collects the trajectory, plus the per-frame health classification and the
keyframe map the CLI exports. Exact QHull hull masks are computed on the
host one frame behind, from a non-blocking copy of the keyframe positions
whose readiness is checked with a CUDA event (never waited on). A resumed
run sets ``state`` (``utils/checkpoint.py``) and ``prev_stamp`` before its
first frame.

Not ported yet (the constructor raises ``NotImplementedError`` for the
options that need them): chunked dispatch, IMU feed and gravity alignment,
host preprocessing, the intensity sidecar, loop closure / refinement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu_torch.core import cloud as cl, se3
from direct_lidar_odometry_tpu_torch.odometry import hosthull, hulls, mapper, pipeline
from direct_lidar_odometry_tpu_torch.odometry.state import FrameResult, OdomState
from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32


@dataclass
class FrameStats:
    stamp: float
    wall_ms: float
    result: FrameResult | None


def _unported(cfg: DloConfig) -> list[str]:
    checks = {
        "imu.use": cfg.imu.use,
        "gravity_align": cfg.gravity_align,
        "host_preprocess": cfg.host_preprocess and cfg.preprocessing.voxel_scan.use,
        "posegraph.use": cfg.posegraph.use,
        "map.carry_intensity": cfg.map.carry_intensity,
    }
    return [name for name, on in checks.items() if on]


class OdometryRunner:
    """Drive one LiDAR sequence through the per-frame step on ``device``.

    ``device="cuda"`` raises when CUDA is unavailable; there is no silent
    move to the CPU. On ``"cpu"`` the kernels' plain versions run.
    """

    def __init__(self, cfg: DloConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OdometryRunner(device='cuda'): CUDA is not available")
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(f"not yet ported: {', '.join(missing)}")
        resolve_backend(cfg)
        pin_float32()
        self.cfg = cfg
        self.device = device
        self.directions = torch.from_numpy(
            hulls.fibonacci_directions(cfg.shapes.hull_directions)
        ).to(device)
        # exact host hull masks (hosthull.py), refreshed one frame behind
        k = cfg.shapes.max_keyframes
        self._hull_cvx = np.zeros((k,), bool)
        self._hull_ccv = np.zeros((k,), bool)
        self._hull_fresh = False
        self._hull_pending = None  # (host buffers, CUDA event or None)
        self._hull_sig = None      # bytes of the last positions hulled
        self._hull_dev = None      # cached device-side mask args
        pin = device.type == "cuda"
        self._hull_bufs = (
            torch.empty((k, 3), dtype=torch.float32, pin_memory=pin),
            torch.empty((), dtype=torch.int32, pin_memory=pin),
            torch.empty((), dtype=torch.float32, pin_memory=pin),
        )
        self.state: OdomState | None = None
        self.prev_stamp: float | None = None
        self.poses: list[torch.Tensor] = []
        self.stamps: list[float] = []
        self.stats: list[FrameStats] = []
        self._identity = torch.eye(4, dtype=torch.float32, device=device)

    def _initial_pose(self) -> torch.Tensor:
        """Known initial pose (odom.cc:600-617); identity otherwise."""
        cfg = self.cfg
        if not cfg.initial_pose.use:
            return self._identity.clone()
        pos = torch.tensor(cfg.initial_pose.position, dtype=torch.float32, device=self.device)
        q = torch.tensor(cfg.initial_pose.orientation_wxyz, dtype=torch.float32, device=self.device)
        return se3.make_se3(se3.quat_to_rotmat(q), pos)

    def process_scan(
        self, points: np.ndarray, stamp: float, sync: bool = False
    ) -> FrameResult | None:
        """One LiDAR frame. Returns None for rejected/initialization frames.

        The step itself reads a few flags on the host, so it returns once
        those reads are done; ``sync=True`` also waits for the rest of the
        frame's device work, so ``FrameStats.wall_ms`` is the frame's
        latency.
        """
        cfg = self.cfg
        t0 = time.perf_counter()
        if points.shape[0] < cfg.gicp.min_num_points:  # odom.cc:638-641
            return None
        raw = self._encode_scan(points)

        if self.state is None:
            state = pipeline.fresh_state(cfg, self._initial_pose(), self.device)
            self.state = pipeline.init_frame(cfg, state, raw.points, raw.mask)
            self._enqueue_hull_fetch(
                torch.tensor(cfg.keyframe.thresh_dist, dtype=torch.float32, device=self.device)
            )
            self.prev_stamp = stamp
            self.poses.append(self.state.pose.clone())
            self.stamps.append(stamp)
            self._finish(sync)
            self.stats.append(FrameStats(stamp, (time.perf_counter() - t0) * 1e3, None))
            return None

        self._refresh_hull_masks()
        self.state, result = pipeline.odom_frame(
            cfg, self.directions, self.state, raw.points, raw.mask,
            self._identity, self._hull_args(),
        )
        self._enqueue_hull_fetch(result.keyframe_thresh_dist)
        self.prev_stamp = stamp
        self.poses.append(result.pose)
        self.stamps.append(stamp)
        self._finish(sync)
        self.stats.append(FrameStats(stamp, (time.perf_counter() - t0) * 1e3, result))
        return result

    def _finish(self, sync: bool) -> None:
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode_scan(self, points: np.ndarray) -> cl.PointCloud:
        """Encode on the host, copy to the device, decode there (the raw
        capacity travels: preprocessing runs on the device)."""
        cap = self.cfg.shapes.n_raw
        if not self.cfg.quantize_transfer:
            return cl.from_numpy(points[:, :3], cap, self.device)
        qs = cl.quantize_for_transfer(points[:, :3], cap)
        # uint16 words travel as int16 bits (dequantize widens them back)
        q = torch.from_numpy(qs.q.view(np.int16)).to(self.device)
        lo = torch.from_numpy(qs.lo).to(self.device)
        scale = torch.from_numpy(qs.scale).to(self.device)
        return cl.dequantize(q, lo, scale, int(qs.count))

    # -- exact host hulls (one frame behind) --------------------------------
    def _refresh_hull_masks(self) -> None:
        """Consume the positions copy enqueued after the previous step, if it
        has landed, and recompute the exact hull masks when the keyframe set
        (or the adaptive alpha) changed. Never waits: an unfinished copy
        stays pending and the masks grow a frame staler."""
        if self._hull_pending is None:
            return
        bufs, event = self._hull_pending
        if event is not None and not event.query():
            return
        self._hull_pending = None
        pos = bufs[0].numpy()
        cnt = int(bufs[1])
        thresh = float(bufs[2])
        sig = pos[:cnt].tobytes() + np.float32(thresh).tobytes()
        if sig == self._hull_sig:
            return
        self._hull_sig = sig
        self._hull_cvx, self._hull_ccv = hosthull.host_hull_masks(
            pos, cnt, thresh, len(self._hull_cvx)
        )
        self._hull_fresh = True
        self._hull_dev = None

    def _enqueue_hull_fetch(self, thresh: torch.Tensor) -> None:
        if self.state is None or self._hull_pending is not None:
            # keep an unconsumed fetch rather than chase the queue tail
            return
        kf = self.state.keyframes
        # copies enqueued behind the producing step, so later in-place ring
        # writes cannot reach them
        for buf, src in zip(self._hull_bufs, (kf.positions, kf.count, thresh)):
            buf.copy_(src, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._hull_pending = (self._hull_bufs, event)

    def _hull_args(self):
        if self._hull_dev is None:
            self._hull_dev = (
                torch.from_numpy(self._hull_cvx).to(self.device),
                torch.from_numpy(self._hull_ccv).to(self.device),
                self._hull_fresh,
            )
        return self._hull_dev

    # -- health -----------------------------------------------------------
    def health_check(self, result: FrameResult, min_corr_frac: float = 0.05) -> str:
        """Classify a frame from its health metrics (SURVEY §5 gap: the
        reference only prints "lm not converged!!" and carries on,
        lsq_registration_impl.hpp:105-108). Reads the frame on the host.

        "diverged": non-finite pose or zero S2M correspondences (the step
        already fell back to the S2S-propagated pose; restart from a
        checkpoint to recover); "degraded": S2S did not converge or either
        stage matched fewer than ``min_corr_frac`` of the scan capacity;
        "ok" otherwise.
        """
        pose = result.pose.cpu().numpy()
        s2s_nc, s2m_nc = int(result.s2s_num_corr), int(result.s2m_num_corr)
        if not np.all(np.isfinite(pose)) or s2m_nc == 0:
            return "diverged"
        n_cap = self.cfg.shapes.n_scan
        weak = s2s_nc < min_corr_frac * n_cap or s2m_nc < min_corr_frac * n_cap
        if not result.s2s_converged or weak:
            return "degraded"
        return "ok"

    # -- outputs ----------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        if not self.poses:
            return np.zeros((0, 4, 4))
        return torch.stack(self.poses).cpu().numpy()

    def build_map(self, out_capacity: int | None = None) -> np.ndarray:
        """The keyframe map, voxel-downsampled at ``map.leaf_size``: [M, 3]."""
        assert self.state is not None
        m = mapper.build_map(self.state.keyframes, self.cfg.map.leaf_size, out_capacity)
        return m.points[m.mask].cpu().numpy()

    def num_keyframes(self) -> int:
        return int(self.state.keyframes.count) if self.state is not None else 0
