"""Host-side sequence runner.

Counterpart of the JAX package's ``odometry/runner.py`` (the reference's
process shell, ``odom_node.cc``, ``odom.cc:586-697``): a Python loop that
encodes each scan, feeds it to the per-frame step on ``device`` and
collects the trajectory; it keeps the IMU buffer (calibration gate, gravity
alignment, the gyro prior integrated on the host), runs a loop-closure
round every ``posegraph.check_every`` frames when one is due, and provides
the per-frame health classification and the keyframe map the CLI exports.
Exact QHull hull masks are computed on the host one frame behind, from a
non-blocking copy of the keyframe positions whose readiness is checked
with a CUDA event. A resumed run sets ``state`` (``utils/checkpoint.py``)
and ``prev_stamp`` before its first frame.

The runner's calls are spans of ``utils/sync.py`` (``runner.scan``,
``runner.chunk``, ``runner.prepare``, ``runner.refine``), and every host
wait on the device goes through it: the IMU prior's, the scans' and the
hull masks' blocking copies, the positions copy's event. It counts the
frames it steps and the scans it prepares.

With ``host_preprocess`` each scan is voxelized and Z-ordered on the host
(``io/hostprep.py``; ``host_prep_impl`` says whether the C++ or the numpy
version ran) and only the n_scan centroids travel. With
``map.carry_intensity`` and [N, 4] xyzi scans, a host sidecar mirrors the
keyframe ring as reduced sensor-frame xyzi scans for
:meth:`OdometryRunner.build_map_xyzi`; which ring slot a frame's keyframe
took is read from a pinned copy once its CUDA event has completed, so the
sidecar adds no host read to a frame.

:meth:`OdometryRunner.process_chunk` is a host loop over the per-frame
step (the JAX package's ``lax.scan`` chunk program is not ported): it gives
the same poses as :meth:`OdometryRunner.process_scan` frame for frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu_torch.core import cloud as cl, se3
from direct_lidar_odometry_tpu_torch.io import hostprep
from direct_lidar_odometry_tpu_torch.odometry import (
    hosthull, hulls, imu as imu_mod, loopclosure, mapper, pipeline,
)
from direct_lidar_odometry_tpu_torch.odometry.state import FrameResult, OdomState
from direct_lidar_odometry_tpu_torch.utils import sync as trace  # process_scan's flag is `sync`
from direct_lidar_odometry_tpu_torch.utils.precision import pin_float32


@dataclass
class FrameStats:
    stamp: float
    wall_ms: float
    result: FrameResult | None


def stack_results(results: list[FrameResult]) -> FrameResult:
    """K per-frame results as one: tensor fields stacked [K, ...], the
    values the step read on the host as lists."""
    fields = {}
    for name in FrameResult._fields:
        values = [getattr(r, name) for r in results]
        fields[name] = torch.stack(values) if isinstance(values[0], torch.Tensor) else values
    return FrameResult(**fields)


class OdometryRunner:
    """Drive one LiDAR sequence through the per-frame step on ``device``.

    ``device="cuda"`` raises when CUDA is unavailable; there is no silent
    move to the CPU. On ``"cpu"`` the kernels' plain versions run.
    """

    def __init__(self, cfg: DloConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OdometryRunner(device='cuda'): CUDA is not available")
        if cfg.host_preprocess and not cfg.preprocessing.voxel_scan.use:
            # host preprocessing moves the voxel + Morton sort off the
            # device; without the voxel filter there is nothing to move
            cfg = cfg.replace(host_preprocess=False)
        resolve_backend(cfg)
        pin_float32()
        self.cfg = cfg
        self.device = device
        # "native" or "numpy" once a scan was preprocessed on the host
        self.host_prep_impl: str | None = None
        self.directions = trace.upload(
            torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions)), device)
        self.imu = (
            imu_mod.ImuBuffer(cfg.imu.calib_time, cfg.imu.buffer_size) if cfg.imu.use else None
        )
        self._kf_at_refine = 0
        self._frames_since_refine_check = 0
        self.refine_log: list[dict] = []
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
        # intensity sidecar (map.carry_intensity): ring slot -> reduced
        # sensor-frame xyzi scan, in step with the device ring through
        # FrameResult.kf_slot; spawns whose slot is not on the host yet
        # wait in _ipending as (pinned slot copy, CUDA event or None, scan)
        self._ikf: dict[int, np.ndarray] = {}
        self._ipending: list[tuple] = []
        self._ipending_max = 32
        self.state: OdomState | None = None
        self.prev_stamp: float | None = None
        self.poses: list[torch.Tensor] = []
        self.stamps: list[float] = []
        self.stats: list[FrameStats] = []
        self._identity = torch.eye(4, dtype=torch.float32, device=device)

    # -- sensor inputs ----------------------------------------------------
    def push_imu(self, stamp: float, gyro, accel) -> None:
        if self.imu is not None:
            self.imu.push(stamp, gyro, accel)

    def _initial_pose(self) -> torch.Tensor:
        """Known initial pose and/or gravity alignment (odom.cc:586-622);
        identity otherwise."""
        cfg = self.cfg
        f32 = dict(dtype=torch.float32, device=self.device)
        rot = torch.eye(3, **f32)
        pos = torch.zeros(3, **f32)
        if cfg.gravity_align and self.imu is not None and self.imu.calibrated:
            rot = se3.quat_to_rotmat(imu_mod.gravity_align_quat(
                trace.upload(self.imu.accel_mean, self.device, torch.float32)))
        if cfg.initial_pose.use:
            pos = trace.upload(cfg.initial_pose.position, self.device, torch.float32)
            rot = se3.quat_to_rotmat(
                trace.upload(cfg.initial_pose.orientation_wxyz, self.device, torch.float32))
        return se3.make_se3(rot, pos)

    def _imu_prior(self, t0: float, t1: float) -> torch.Tensor:
        """Rotation prior from the gyro samples between two scan stamps,
        integrated on the host (identity without an IMU)."""
        if self.imu is None:
            return self._identity
        window, count = self.imu.window(t0, t1, self.cfg.shapes.imu_window)
        return trace.upload(torch.from_numpy(imu_mod.integrate_window_host(window, count)),
                            self.device)

    def process_scan(
        self, points: np.ndarray, stamp: float, sync: bool = False
    ) -> FrameResult | None:
        """One LiDAR frame. Returns None for rejected/initialization frames
        and, with ``imu.use``, for frames before the IMU is calibrated
        (the reference waits for calibration, odom.cc:589-591).

        The step itself reads a few flags on the host, so it returns once
        those reads are done; ``sync=True`` also waits for the rest of the
        frame's device work, so ``FrameStats.wall_ms`` (the span
        ``runner.scan``) is the frame's latency.
        """
        cfg = self.cfg
        if points.shape[0] < cfg.gicp.min_num_points:  # odom.cc:638-641
            return None
        if self.imu is not None and not self.imu.calibrated:
            return None
        with trace.span("runner.scan") as span:
            raw = self._encode_scan(points)
            if self.state is None:
                self._init_frame(raw, points)
                result = None
                self.poses.append(self.state.pose.clone())
            else:
                result = self._step(raw, self._imu_prior(self.prev_stamp, stamp), points)
                self.poses.append(result.pose)
            self.prev_stamp = stamp
            self.stamps.append(stamp)
            self._finish(sync)
        self.stats.append(FrameStats(stamp, span.ms, result))
        if result is not None and cfg.posegraph.use:
            # the trigger reads the keyframe count on the host, so it runs
            # only every check_every frames
            self._frames_since_refine_check += 1
            if self._frames_since_refine_check >= cfg.posegraph.check_every:
                self._frames_since_refine_check = 0
                self.maybe_refine()
        return result

    def _init_frame(self, raw: cl.PointCloud, points: np.ndarray) -> None:
        cfg = self.cfg
        state = pipeline.fresh_state(cfg, self._initial_pose(), self.device)
        self.state = pipeline.init_frame(cfg, state, raw.points, raw.mask)
        if self._carry_intensity(points):
            # the init frame always writes ring slot 0 (odom.cc:483-505)
            self._ikf[0] = self._reduce_xyzi(points)
        self._enqueue_hull_fetch(
            trace.upload(cfg.keyframe.thresh_dist, self.device, torch.float32))

    def _step(self, raw: cl.PointCloud, prior: torch.Tensor, points: np.ndarray,
              wait_hulls: bool = False) -> FrameResult:
        self._refresh_hull_masks(wait=wait_hulls)
        self.state, result = pipeline.odom_frame(
            self.cfg, self.directions, self.state, raw.points, raw.mask, prior,
            self._hull_args(),
        )
        trace.count("frames")
        self._enqueue_hull_fetch(result.keyframe_thresh_dist)
        if result.new_keyframe and self._carry_intensity(points):
            self._enqueue_intensity(result.kf_slot, points)
        return result

    def _finish(self, sync: bool) -> None:
        if sync and self.device.type == "cuda":
            trace.wait_event(self.device)

    # -- chunked dispatch ---------------------------------------------------
    def prepare_chunk(self, scans) -> list[cl.PointCloud]:
        """Encode a chunk of scans and copy them to the device (separate
        from :meth:`process_chunk`, so a caller can prepare the next chunk
        while the current one runs)."""
        with trace.span("runner.prepare"):
            trace.count("frames_prepared", len(scans))
            return [self._encode_scan(s) for s in scans]

    def process_chunk(self, scans, stamps, prepared: list[cl.PointCloud] | None = None) -> FrameResult:
        """K frames after an initialized state (feed the first frame through
        :meth:`process_scan`); scans below ``gicp.min_num_points`` must be
        filtered by the caller. A host loop over the per-frame step with
        the IMU priors integrated up front; the hull masks stay exactly one
        frame behind (each frame waits for the previous frame's positions
        copy), so the poses equal those of ``process_scan(..., sync=True)``
        frame for frame. Returns the results stacked (:func:`stack_results`).
        ``prepared``: the same scans through :meth:`prepare_chunk`. No
        loop-closure round is triggered inside a chunk, as in the JAX
        package."""
        if self.state is None:
            raise RuntimeError("process_chunk needs an initialized state: call process_scan first")
        k = len(scans)
        if k == 0 or k != len(stamps):
            raise ValueError(f"process_chunk: {k} scans and {len(stamps)} stamps")
        with trace.span("runner.chunk") as span:
            prev = [self.prev_stamp, *stamps[:-1]]
            priors = [self._imu_prior(a, b) for a, b in zip(prev, stamps)]
            raws = prepared if prepared is not None else self.prepare_chunk(scans)
            results = [self._step(raw, prior, scan, wait_hulls=True)
                       for raw, prior, scan in zip(raws, priors, scans)]
            self.prev_stamp = stamps[-1]
            stacked = stack_results(results)
        wall = span.ms / k
        for stamp, res in zip(stamps, results):
            self.poses.append(res.pose)
            self.stamps.append(stamp)
            self.stats.append(FrameStats(stamp, wall, res))
        return stacked

    def _wire_capacity(self) -> int:
        """Points a scan carries on the wire: the voxel capacity when the
        host preprocesses (~4x fewer), the raw capacity otherwise."""
        cfg = self.cfg
        return cfg.shapes.n_scan if cfg.host_preprocess else cfg.shapes.n_raw

    def _prep_points(self, points: np.ndarray) -> np.ndarray:
        """With ``host_preprocess``, NaN/crop/voxel/Morton on the host
        (``io/hostprep.py``), so the device step skips them."""
        cfg = self.cfg
        if not cfg.host_preprocess:
            return points
        crop = cfg.preprocessing.crop.size if cfg.preprocessing.crop.use else None
        self.host_prep_impl = hostprep.implementation()
        return hostprep.preprocess_morton(points, crop, cfg.preprocessing.voxel_scan.res,
                                          cfg.shapes.n_scan)

    def _encode_scan(self, points: np.ndarray) -> cl.PointCloud:
        """Preprocess on the host if configured, encode, copy to the device,
        decode there."""
        pts = self._prep_points(points)[:, :3]
        cap = self._wire_capacity()
        if not self.cfg.quantize_transfer:
            return cl.from_numpy(pts, cap, self.device)
        qs = cl.quantize_for_transfer(pts, cap)
        # uint16 words travel as int16 bits (dequantize widens them back)
        q = trace.upload(torch.from_numpy(qs.q.view(np.int16)), self.device)
        lo = trace.upload(torch.from_numpy(qs.lo), self.device)
        scale = trace.upload(torch.from_numpy(qs.scale), self.device)
        return cl.dequantize(q, lo, scale, int(qs.count))

    # -- exact host hulls (one frame behind) --------------------------------
    def _refresh_hull_masks(self, wait: bool = False) -> None:
        """Consume the positions copy enqueued after the previous step, if it
        has landed, and recompute the exact hull masks when the keyframe set
        (or the adaptive alpha) changed. Without ``wait`` an unfinished copy
        stays pending and the masks grow a frame staler; with it, the copy
        is waited for."""
        if self._hull_pending is None:
            return
        bufs, event = self._hull_pending
        if event is not None:
            if wait:
                trace.wait_event(event)
            elif not event.query():
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
                trace.upload(torch.from_numpy(self._hull_cvx), self.device),
                trace.upload(torch.from_numpy(self._hull_ccv), self.device),
                self._hull_fresh,
            )
        return self._hull_dev

    # -- intensity sidecar (map.carry_intensity) ----------------------------
    def _carry_intensity(self, points: np.ndarray) -> bool:
        return bool(self.cfg.map.carry_intensity) and points.shape[1] >= 4

    def _reduce_xyzi(self, points: np.ndarray) -> np.ndarray:
        p = self.cfg.preprocessing
        return hostprep.reduce_keyframe_scan_xyzi(
            points,
            p.crop.size if p.crop.use else None,
            p.voxel_scan.res if p.voxel_scan.use else None,
            p.voxel_submap.res if p.voxel_submap.use else None,
            self.cfg.shapes.n_keyframe,
        )

    def _enqueue_intensity(self, kf_slot: torch.Tensor, points: np.ndarray) -> None:
        """Queue a spawning frame's scan behind a copy of its ring slot that
        lands in pinned memory, with a CUDA event after it."""
        pin = self.device.type == "cuda"
        slot = torch.empty((), dtype=torch.int32, pin_memory=pin)
        slot.copy_(kf_slot, non_blocking=True)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        self._ipending.append((slot, event, points))
        self._resolve_intensity()

    def _resolve_intensity(self, force: bool = False) -> None:
        """File the pending scans whose slot copy has landed, oldest first.
        Waits only when ``force`` or for the entries beyond the queue's
        bound, the oldest, whose frames are long done."""
        overflow = len(self._ipending) - self._ipending_max
        done = 0
        for n, (slot, event, scan) in enumerate(self._ipending):
            if event is not None:
                if force or n < overflow:
                    trace.wait_event(event)
                elif not event.query():
                    break
            self._ikf[int(slot)] = self._reduce_xyzi(scan)
            done = n + 1
        del self._ipending[:done]

    def build_map_xyzi(self) -> np.ndarray:
        """The intensity-carrying map, [P, 4] xyzi: the sidecar's scans at
        the CURRENT keyframe poses (a loop-closure re-anchoring shows).
        Needs ``map.carry_intensity`` and [N, 4] scans."""
        assert self.state is not None
        self._resolve_intensity(force=True)
        kf = self.state.keyframes
        return mapper.build_map_xyzi(self._ikf, kf.positions.cpu().numpy(),
                                     kf.quats.cpu().numpy(), self.cfg.map.leaf_size)

    def has_intensity_map(self) -> bool:
        """True when the sidecar holds any keyframe scan."""
        return bool(self._ikf or self._ipending)

    # -- loop closure / map refinement -------------------------------------
    def maybe_refine(self, force: bool = False) -> dict | None:
        """Run a loop-closure + pose-graph refinement round if due.

        Due = at least ``posegraph.refine_every_kf`` keyframes were added
        since the last round (``force=True`` skips that gate) and enough
        keyframes exist to admit a loop (``min_index_gap``). Re-anchors the
        live state (keyframe ring, clouds, current pose, cached submap);
        returns a diagnostics dict, or None when skipped.
        """
        cfg = self.cfg
        if self.state is None:
            return None
        n_kf = trace.read(self.state.keyframes.count)
        if not self._refine_due(n_kf, force):
            return None
        with trace.span("runner.refine") as span:
            self.state, info = loopclosure.refine_and_reanchor(self.state, cfg,
                                                               resolve_backend(cfg))
            graph_error, max_corr = trace.read(
                torch.stack([info.graph_error, info.max_correction]))
        self._kf_at_refine = n_kf
        entry = {
            "frame": len(self.poses),
            "n_keyframes": n_kf,
            "n_candidates": info.n_candidates,
            "n_accepted": info.n_accepted,
            "graph_error": graph_error,
            "max_correction_m": max_corr,
            "wall_ms": span.ms,
        }
        self.refine_log.append(entry)
        return entry

    def _refine_due(self, n_kf: int, force: bool = False) -> bool:
        """The trigger's gates for a ring of ``n_kf`` keyframes: enough
        keyframes to admit a loop, and (unless ``force``)
        ``refine_every_kf`` added since the last round."""
        pg = self.cfg.posegraph
        if n_kf < pg.min_index_gap + 2:
            return False
        return force or n_kf - self._kf_at_refine >= pg.refine_every_kf

    # -- health -----------------------------------------------------------
    def health_check(self, result: FrameResult, min_corr_frac: float = 0.05) -> str:
        """Classify a frame from its health metrics (SURVEY §5 gap: the
        reference only prints "lm not converged!!" and carries on,
        lsq_registration_impl.hpp:105-108). Reads the frame on the host.

        "diverged": non-finite pose or zero S2M correspondences (the step
        already fell back to the S2S-propagated pose; restart from a
        checkpoint to recover); "degraded": S2S did not converge or either
        stage matched fewer than ``min_corr_frac`` of the scan capacity;
        "ok" otherwise. A stacked result (:meth:`process_chunk`) is
        classified by its worst frame.
        """
        pose = result.pose.cpu().numpy()
        s2s_nc = int(result.s2s_num_corr.min())
        s2m_nc = int(result.s2m_num_corr.min())
        if not np.all(np.isfinite(pose)) or s2m_nc == 0:
            return "diverged"
        n_cap = self.cfg.shapes.n_scan
        weak = s2s_nc < min_corr_frac * n_cap or s2m_nc < min_corr_frac * n_cap
        if not all(np.atleast_1d(result.s2s_converged)) or weak:
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
