"""The benchmark's traffic generator: box worlds and their LiDAR sweeps.

- :func:`make_urban_world`: a frozen numpy copy of the port's
  ``io/synthetic.make_urban_world`` (buildings lining a corridor, parked
  cars, fences, poles, trees with diffuse canopies, moving boxes), made
  from a numpy generator.
- :func:`render`: the ray-cast sweep of one frame, on the device: every
  (beam, azimuth) ray of the sensor against the ground plane and, by the
  slab test, every box near the sensor; the nearest hit in range, radial
  noise along the beam. The same semantics as the port's
  ``io/synthetic.render_raycast`` (frozen in ``benchmark/reference/raycast.py``),
  vectorised over rays and boxes instead of looping over boxes.
- :func:`imu_rows`: the 100 Hz gyro of a drive, from its true motion with
  white noise and no bias (the arithmetic of the port's
  ``io/synthetic.make_imu_between``, frozen), after a rest of the IMU's
  calibration time before the first sweep.

Everything a run renders comes from its ``--seed`` through
:func:`seed_words`, so the same seed gives the same scans.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class BoxWorld:
    boxes: np.ndarray     # [B, 6] (cx, cy, cz, sx, sy, sz)
    poses: np.ndarray     # [T, 4, 4] sensor poses
    stamps: np.ndarray    # [T] seconds
    ground_z: float = 0.0
    rough: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))
    dynamic_boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 6), np.float32))
    dynamic_vel: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))


@dataclass(frozen=True)
class Sensor:
    n_beams: int
    n_azimuth: int
    fov_up_deg: float
    fov_down_deg: float
    max_range: float
    min_range: float = 0.5
    noise: float = 0.01

    @property
    def n_rays(self) -> int:
        return self.n_beams * self.n_azimuth


def seed_words(seed: int, *stream: int) -> np.random.SeedSequence:
    """A seed sequence for one stream of a run (a drive, a lane, a sample)."""
    return np.random.SeedSequence([int(seed) % 2**64, *stream])


def make_urban_world(
    rng: np.random.Generator,
    n_frames: int = 50,
    speed: float = 1.2,
    dt: float = 0.1,
    yaw_rate: float = 0.04,
    corridor: float = 14.0,
    n_dynamic: int = 2,
    closed_loop: bool = False,
    z_amplitude: float = 0.0,
) -> BoxWorld:
    """Urban-corridor box world along a smooth wander (or, with
    ``closed_loop``, a circle of ``speed * n_frames`` metres)."""
    poses = np.zeros((n_frames, 4, 4))
    stamps = np.arange(n_frames) * dt
    if closed_loop:
        radius = speed * n_frames / (2 * np.pi)
        for t in range(n_frames):
            a = 2 * np.pi * t / n_frames
            c, s = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
            poses[t] = np.eye(4)
            poses[t, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            poses[t, :3, 3] = [radius * np.cos(a), radius * np.sin(a),
                               1.5 + z_amplitude * np.sin(2 * a)]
    else:
        yaw = 0.0
        yaw_vel = 0.0
        pos = np.array([0.0, 0.0, 1.5])
        for t in range(n_frames):
            yaw_vel = 0.8 * yaw_vel + rng.normal(scale=yaw_rate)
            yaw_vel = np.clip(yaw_vel, -0.09, 0.09)
            yaw += yaw_vel * dt * 10
            c, s = np.cos(yaw), np.sin(yaw)
            poses[t] = np.eye(4)
            poses[t, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            poses[t, :3, 3] = pos
            pos = pos + poses[t, :3, :3] @ np.array([speed * dt * 10, 0, 0])
    boxes = []
    path = poses[:, :3, 3]
    step = max(1, int(6.0 / max(speed * dt * 10, 1e-6)))
    for t in range(0, n_frames, step):
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        for side in (-1.0, 1.0):
            if rng.uniform() < 0.15:
                continue
            off = corridor + rng.uniform(0.0, 10.0)
            size = np.array([rng.uniform(5, 14), rng.uniform(5, 14), rng.uniform(5, 18)])
            c = path[t] + side * off * left + fwd * rng.uniform(-3, 3)
            boxes.append([c[0], c[1], size[2] / 2, *size])
    path_len = max(speed * dt * 10 * n_frames, 1.0)
    for _ in range(int(path_len * 1.0)):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        c = (path[t] + rng.uniform(4.0, corridor * 0.9) * left
             * (1 if rng.uniform() < 0.5 else -1) + fwd * rng.uniform(-8, 8))
        size = np.array([rng.uniform(3.2, 5.2), rng.uniform(1.6, 2.1), rng.uniform(1.3, 2.1)])
        boxes.append([c[0], c[1], size[2] / 2, *size])
    for _ in range(int(path_len / 9.0) + 2):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        side = 1 if rng.uniform() < 0.5 else -1
        c = path[t] + side * rng.uniform(5.0, corridor) * left + fwd * rng.uniform(-6, 6)
        length = rng.uniform(6, 18)
        size = np.array([length, rng.uniform(0.2, 0.8), rng.uniform(0.8, 1.6)])
        if abs(fwd[1]) > abs(fwd[0]):
            size = size[[1, 0, 2]]
        boxes.append([c[0], c[1], size[2] / 2, *size])
    for _ in range(int(path_len * 0.6)):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        c = path[t] + rng.uniform(-corridor, corridor) * left + fwd * rng.uniform(-8, 8)
        size = np.array([rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9), rng.uniform(0.8, 3.0)])
        boxes.append([c[0], c[1], size[2] / 2, *size])
    rough = [0.0] * len(boxes)
    for _ in range(int(path_len / 5.0) + 2):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        side = 1 if rng.uniform() < 0.5 else -1
        c = path[t] + side * rng.uniform(5.0, corridor + 6.0) * left + fwd * rng.uniform(-5, 5)
        trunk_h = rng.uniform(1.8, 3.5)
        trunk = np.array([rng.uniform(0.2, 0.5), rng.uniform(0.2, 0.5), trunk_h])
        boxes.append([c[0], c[1], trunk_h / 2, *trunk])
        rough.append(0.0)
        canopy = np.array([rng.uniform(3.0, 7.5), rng.uniform(3.0, 7.5), rng.uniform(2.5, 5.5)])
        boxes.append([c[0] + rng.uniform(-0.5, 0.5), c[1] + rng.uniform(-0.5, 0.5),
                      trunk_h + canopy[2] / 2, *canopy])
        rough.append(rng.uniform(0.05, 0.12))
    world = BoxWorld(boxes=np.asarray(boxes, np.float32), poses=poses, stamps=stamps,
                     rough=np.asarray(rough, np.float32))
    if n_dynamic:
        dyn, vel = [], []
        for _ in range(n_dynamic):
            t = rng.integers(n_frames)
            c = path[t] + np.array([rng.uniform(-10, 10), rng.uniform(-10, 10), 0.0])
            size = np.array([rng.uniform(1.5, 4.0), rng.uniform(1.2, 2.0), rng.uniform(1.2, 1.8)])
            a = rng.uniform(0, 2 * np.pi)
            v = rng.uniform(0.5, 2.0) * np.array([np.cos(a), np.sin(a), 0.0])
            dyn.append([c[0], c[1], size[2] / 2, *size])
            vel.append(v)
        world.dynamic_boxes = np.asarray(dyn, np.float32)
        world.dynamic_vel = np.asarray(vel, np.float32)
    return world


def build_world(world_cfg: dict, n_frames: int, closed_loop: bool,
                seq: np.random.SeedSequence) -> BoxWorld:
    """A configuration's world (its ``world`` block: speed, corridor
    width, moving boxes, sensor height) for ``n_frames`` frames."""
    speed = world_cfg["speed_m_per_frame"]
    n_dyn = max(world_cfg["dynamic_min"], n_frames // world_cfg["dynamic_per_frames"])
    world = make_urban_world(np.random.default_rng(seq), n_frames=n_frames, speed=speed,
                             corridor=world_cfg["corridor_m"], n_dynamic=n_dyn,
                             closed_loop=closed_loop)
    world.poses[:, 2, 3] += world_cfg["sensor_height_m"] - 1.5
    return world


def beam_directions(sensor: Sensor, jitter_el: torch.Tensor, jitter_az: torch.Tensor) -> torch.Tensor:
    """Sensor-frame unit rays [n_beams * n_azimuth, 3], each jittered
    inside its (elevation, azimuth) bin by the given uniforms in [0, 1)."""
    lo, hi = np.deg2rad(sensor.fov_down_deg), np.deg2rad(sensor.fov_up_deg)
    dev = jitter_el.device
    el = lo + (torch.arange(sensor.n_beams, device=dev, dtype=torch.float64) + jitter_el) * (
        (hi - lo) / sensor.n_beams)
    az = -np.pi + (torch.arange(sensor.n_azimuth, device=dev, dtype=torch.float64)
                   + jitter_az) * (2 * np.pi / sensor.n_azimuth)
    d = torch.stack([torch.cos(el)[:, None] * torch.cos(az)[None, :],
                     torch.cos(el)[:, None] * torch.sin(az)[None, :],
                     torch.sin(el)[:, None].expand(-1, sensor.n_azimuth)], dim=-1)
    return d.to(torch.float32).reshape(-1, 3)


class DeviceWorld:
    """A world's boxes on the device, ready for :func:`render`."""

    def __init__(self, world: BoxWorld, device):
        self.world = world
        f32 = dict(dtype=torch.float32, device=device)
        rough = world.rough if len(world.rough) == len(world.boxes) else np.zeros(len(world.boxes))
        self.boxes = torch.as_tensor(world.boxes, **f32).reshape(-1, 6)
        self.rough = torch.as_tensor(rough, **f32)
        self.dyn = torch.as_tensor(world.dynamic_boxes, **f32).reshape(-1, 6)
        self.dyn_vel = torch.as_tensor(world.dynamic_vel, **f32).reshape(-1, 3)
        self.device = torch.device(device)


def raycast(dw: DeviceWorld, pose: np.ndarray, stamp: float, dirs: torch.Tensor,
            sensor: Sensor, box_chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit distance and the hit surface's extra noise sigma of each
    ray (inf where nothing lies in range)."""
    f32 = dict(dtype=torch.float32, device=dw.device)
    o = torch.as_tensor(pose[:3, 3], **f32)
    rot = torch.as_tensor(pose[:3, :3], **f32)
    d_w = (dirs[:, None, :] * rot[None, :, :]).sum(-1)
    t_hit = torch.full((len(dirs),), torch.inf, **f32)
    sigma = torch.zeros((len(dirs),), **f32)
    dz = d_w[:, 2]
    tg = (dw.world.ground_z - o[2]) / dz
    hit_g = (dz < 0) & (tg > sensor.min_range)
    t_hit = torch.where(hit_g, tg, t_hit)
    boxes, rough = dw.boxes, dw.rough
    if len(dw.dyn):
        dyn = dw.dyn.clone()
        dyn[:, :3] += dw.dyn_vel * float(stamp)
        boxes = torch.cat([boxes, dyn])
        rough = torch.cat([rough, torch.zeros(len(dyn), **f32)])
    if len(boxes):
        ctr, half = boxes[:, :3], boxes[:, 3:] * 0.5
        dist2d = torch.linalg.norm(ctr[:, :2] - o[None, :2], dim=1)
        rad2d = torch.linalg.norm(half[:, :2], dim=1)
        near = (dist2d - rad2d) < sensor.max_range
        lo_rel = (ctr - half - o)[near]
        hi_rel = (ctr + half - o)[near]
        rough_n = rough[near]
        inv = torch.where(d_w.abs() > 1e-12, 1.0 / d_w, torch.full_like(d_w, 1e12))
        for a in range(0, len(lo_rel), box_chunk):
            t1 = lo_rel[None, a:a + box_chunk] * inv[:, None, :]
            t2 = hi_rel[None, a:a + box_chunk] * inv[:, None, :]
            tmin = torch.minimum(t1, t2).amax(-1)
            tmax = torch.maximum(t1, t2).amin(-1)
            valid = (tmax >= tmin) & (tmin > sensor.min_range)
            tmin = torch.where(valid, tmin, torch.inf)
            best, which = tmin.min(dim=1)
            upd = best < t_hit
            t_hit = torch.where(upd, best, t_hit)
            sigma = torch.where(upd, rough_n[a:a + box_chunk][which], sigma)
    return t_hit, sigma


def render(dw: DeviceWorld, frame: int, sensor: Sensor, gen: torch.Generator,
           stamp: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep from pose ``frame``: sensor-frame points [n_rays, 3] and
    their mask (a return in range). Rays without a return hold zeros."""
    dev = dw.device
    jit_el = torch.rand(sensor.n_beams, generator=gen, device=dev, dtype=torch.float64)
    jit_az = torch.rand(sensor.n_azimuth, generator=gen, device=dev, dtype=torch.float64)
    dirs = beam_directions(sensor, jit_el, jit_az)
    if stamp is None:
        stamp = float(dw.world.stamps[frame])
    t_hit, sigma = raycast(dw, dw.world.poses[frame], stamp, dirs, sensor)
    ok = (t_hit > sensor.min_range) & (t_hit < sensor.max_range)
    r = torch.where(ok, t_hit, 1.0)
    eps = torch.randn(len(r), generator=gen, device=dev, dtype=torch.float32)
    eps = eps * torch.sqrt(sensor.noise * sensor.noise + sigma * sigma)
    pts = dirs * (r * (1.0 + eps / r))[:, None]
    return torch.where(ok[:, None], pts, 0.0), ok


def body_rate(r0: np.ndarray, r1: np.ndarray, dt: float) -> np.ndarray:
    """The constant body angular velocity taking rotation ``r0`` to ``r1``
    in ``dt`` seconds: log(r0^T r1) / dt."""
    d = r0.T @ r1
    theta = np.arccos(np.clip((np.trace(d) - 1.0) / 2.0, -1.0, 1.0))
    if theta < 1e-9:
        return np.zeros(3)
    axis = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return theta / (2.0 * np.sin(theta)) * axis / dt


def imu_rows(rotations: np.ndarray, stamps: np.ndarray, rate_hz: float, noise: float,
             rest_s: float, seq: np.random.SeedSequence) -> list[np.ndarray]:
    """IMU rows (stamp, wx, wy, wz, ax, ay, az) by frame: rows[0] the rest
    before the first sweep (stamps from ``-rest_s`` to the first sweep's,
    at rest), rows[t] the samples in (stamps[t - 1], stamps[t]], each at the
    interval's constant body rate. Gyro noise is white (``noise`` rad/s),
    the accelerometer reads gravity in the body frame."""
    rng = np.random.default_rng(seq)
    g = np.array([0.0, 0.0, 9.81])
    n_rest = int(round(rest_s * rate_hz))
    ts = stamps[0] - rest_s + np.arange(n_rest + 1) / rate_hz
    rest = np.zeros((len(ts), 7))
    rest[:, 0] = ts
    rest[-1, 0] = stamps[0]
    rest[:, 1:4] = rng.normal(scale=noise, size=(len(ts), 3))
    rest[:, 4:7] = rotations[0].T @ g
    rows = [rest]
    for t in range(1, len(stamps)):
        t0, t1 = float(stamps[t - 1]), float(stamps[t])
        n = max(int(round((t1 - t0) * rate_hz)), 1)
        out = np.zeros((n, 7))
        out[:, 0] = t0 + (np.arange(n) + 1) * ((t1 - t0) / n)
        out[-1, 0] = t1
        out[:, 1:4] = body_rate(rotations[t - 1], rotations[t], t1 - t0) + rng.normal(
            scale=noise, size=(n, 3))
        out[:, 4:7] = rotations[t - 1].T @ g
        rows.append(out)
    return rows
