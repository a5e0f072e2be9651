"""Ray-cast LiDAR world and scan generator (host-side, numpy).

The parts of the JAX package's ``io/synthetic.py`` that drive the port on
the card (``chip_smoke.py``): the urban-corridor :class:`BoxWorld`, the
OS1-64 :class:`BeamModel` and the exact ray-cast renderer. They are copied,
not imported, because importing any module of the JAX package runs that
package's ``__init__``; ``tests/test_torch_io.py`` checks that both copies
render identical scans from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BoxWorld:
    """Analytic world for exact ray-cast rendering: ground plane + boxes.

    Unlike the point-soup :class:`SyntheticWorld` (surfaces sampled into
    points; occlusion approximated by a z-buffer over those samples), a
    BoxWorld is rendered by intersecting each beam ray with axis-aligned
    boxes and the ground plane — exact occlusion, exact beam pattern,
    realistic fill at any range, no sampling-density knobs. This is the
    round-5 bench world: the reference validates on a real spinning-
    scanner rosbag (``README.md:61-76``) and a ray-cast sweep is the
    closest a zero-egress environment can get to one.
    """

    boxes: np.ndarray    # [B, 6] rows (cx, cy, cz, sx, sy, sz)
    poses: np.ndarray    # [T, 4, 4] ground-truth sensor poses
    stamps: np.ndarray   # [T] seconds
    ground_z: float = 0.0
    # per-box extra radial noise sigma (metres): 0 for crisp built
    # surfaces, ~0.05-0.12 for foliage — a LiDAR return off a canopy is a
    # diffuse shell, not a plane, and registration must live with that
    rough: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.float32))
    # moving boxes: pose at t=0 plus constant world-frame velocity
    dynamic_boxes: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 6), np.float32))
    dynamic_vel: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))


@dataclass(frozen=True)
class BeamModel:
    """Spinning-scanner geometry for occluded rendering (HDL-64 class).

    The reference's acceptance artifact is a rosbag from a real spinning
    LiDAR (``README.md:61-76``); this model reproduces the three
    properties of such data that the plain point-soup renderer lacks
    (round-4 verdict): occlusion (a z-buffer keeps the nearest return per
    (elevation, azimuth) bin, so surfaces shadow what is behind them),
    a polar beam pattern (ring structure, range-dependent density), and
    radial range noise. Defaults follow the Ouster OS1-64 (64 beams,
    +-16.6 deg vertical FOV, 1024 columns at 10 Hz) — the sensor class
    behind the reference's own acceptance rosbag (vectr-ucla campus
    sequence; ``README.md:61-76``). For a KITTI HDL-64E car-roof model
    pass ``BeamModel(n_azimuth=2048, fov_up_deg=2.0, fov_down_deg=-24.8)``.
    """

    n_beams: int = 64
    n_azimuth: int = 1024
    fov_up_deg: float = 16.6
    fov_down_deg: float = -16.6
    # occlusion test pools the per-bin z-buffer over +-occl_pool AZIMUTH
    # neighbors (same elevation row): a return survives only if no
    # neighboring bin saw a surface more than `slack` nearer. Pooling
    # closes the leak-through holes a sparsely sampled front surface
    # would otherwise leave (surfaces here are point soups, not meshes);
    # slack keeps genuine foreground returns at silhouette edges alive.
    # Pooling must NOT cross elevation rows: on grazing surfaces (ground)
    # the in-surface range changes by ~r^2*d_el/h per row (metres at
    # range), so an elevation-pooled z-buffer would cull the ground with
    # its own nearer rows.
    occl_pool: int = 1
    occl_slack_abs: float = 0.35
    occl_slack_rel: float = 0.02


def _beam_dirs(beams: BeamModel, rng: np.random.Generator) -> np.ndarray:
    """Unit ray directions for every (beam, azimuth) bin, jittered within
    the bin (real scanner phase varies frame to frame; exact bin centers
    would alias consecutive sweeps onto identical rays)."""
    lo, hi = np.deg2rad(beams.fov_down_deg), np.deg2rad(beams.fov_up_deg)
    el = lo + (np.arange(beams.n_beams) + rng.uniform(0, 1, beams.n_beams)) * (
        (hi - lo) / beams.n_beams)
    az = -np.pi + (np.arange(beams.n_azimuth)
                   + rng.uniform(0, 1, beams.n_azimuth)) * (
        2 * np.pi / beams.n_azimuth)
    ce, se = np.cos(el), np.sin(el)
    ca, sa = np.cos(az), np.sin(az)
    d = np.empty((beams.n_beams, beams.n_azimuth, 3), np.float32)
    d[..., 0] = ce[:, None] * ca[None, :]
    d[..., 1] = ce[:, None] * sa[None, :]
    d[..., 2] = se[:, None]
    return d.reshape(-1, 3)


def render_raycast(
    world: BoxWorld,
    frame: int,
    rng: np.random.Generator,
    max_range: float = 40.0,
    min_range: float = 0.5,
    max_points: int = 1 << 20,
    noise: float = 0.01,
    beams: BeamModel | None = None,
) -> np.ndarray:
    """Exact ray-cast sweep of a BoxWorld: one return per beam ray (the
    nearest ground/box intersection within range), radial noise, sensor
    frame. Dynamic boxes are advanced to ``stamps[frame]``."""
    beams = beams or BeamModel()
    T = world.poses[frame]
    o = T[:3, 3].astype(np.float32)
    R = T[:3, :3].astype(np.float32)
    d_s = _beam_dirs(beams, rng)          # sensor frame
    d_w = d_s @ R.T                        # world frame
    n_rays = len(d_w)
    t_hit = np.full(n_rays, np.inf, np.float32)
    # ground plane: o_z + t*d_z = ground_z
    dz = d_w[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (world.ground_z - o[2]) / dz
    hit_g = (dz < 0) & (tg > min_range)
    t_hit[hit_g] = tg[hit_g].astype(np.float32)
    sigma = np.zeros(n_rays, np.float32)  # per-hit extra radial noise
    # boxes: slab method, chunked over nearby boxes
    boxes = world.boxes
    rough = world.rough
    if len(rough) < len(boxes):
        rough = np.zeros(len(boxes), np.float32)
    if len(world.dynamic_boxes):
        dynb = world.dynamic_boxes.copy()
        dynb[:, :3] += world.dynamic_vel * float(world.stamps[frame])
        boxes = np.concatenate([boxes, dynb], axis=0) if len(boxes) else dynb
        rough = np.concatenate([rough, np.zeros(len(dynb), np.float32)])
    if len(boxes):
        ctr, half = boxes[:, :3], boxes[:, 3:] * 0.5
        dist2d = np.linalg.norm(ctr[:, :2] - o[None, :2], axis=1)
        rad2d = np.linalg.norm(half[:, :2], axis=1)
        near = (dist2d - rad2d) < max_range
        ctr = ctr[near].astype(np.float32)
        half = half[near].astype(np.float32)
        rough_n = rough[near]
        dist2d, rad2d = dist2d[near], rad2d[near]
        inv = np.where(np.abs(d_w) > 1e-12, 1.0 / d_w, 1e12).astype(np.float32)
        t_grid = t_hit.reshape(beams.n_beams, beams.n_azimuth)
        sig_grid = sigma.reshape(beams.n_beams, beams.n_azimuth)
        inv_g = inv.reshape(beams.n_beams, beams.n_azimuth, 3)
        # each box only subtends a narrow azimuth wedge as seen from the
        # sensor — slab-test just those ray columns (exact: the wedge is
        # widened by the box's circumscribed radius). The ray grid's
        # azimuth axis is SENSOR-frame, so the wedge centre must be too
        # (a world-frame wedge drifts off the box columns as the robot
        # yaws — boxes silently vanished past ~45 deg of heading change)
        rel_ctr_s = (ctr - o) @ R  # d_w = d_s @ R.T  =>  d_s = d_w @ R
        az_ctr = np.arctan2(rel_ctr_s[:, 1], rel_ctr_s[:, 0])
        with np.errstate(invalid="ignore"):
            az_half = np.arcsin(np.minimum(rad2d / np.maximum(dist2d, 1e-9), 1.0))
        col_ctr = (az_ctr + np.pi) * (beams.n_azimuth / (2 * np.pi))
        col_half = np.ceil(
            az_half * (beams.n_azimuth / (2 * np.pi))).astype(np.int64) + 1
        lo_rel = ctr - half - o
        hi_rel = ctr + half - o
        for b in range(len(ctr)):
            if dist2d[b] <= rad2d[b]:  # sensor inside the box footprint
                cols = np.arange(beams.n_azimuth)
            else:
                cols = (np.arange(-col_half[b], col_half[b] + 1)
                        + int(col_ctr[b])) % beams.n_azimuth
            iv = inv_g[:, cols]                     # [n_beams, W, 3]
            t1 = lo_rel[b] * iv
            t2 = hi_rel[b] * iv
            tmin = np.minimum(t1, t2).max(axis=-1)
            tmax = np.maximum(t1, t2).min(axis=-1)
            # require the ENTRY face in front of the sensor: an origin
            # inside a solid box sees nothing (tmin <= 0 < tmax used to
            # emit a garbage min_range shell that the crop then deleted —
            # empty scans whenever a trajectory clipped a building)
            valid = (tmax >= tmin) & (tmin > min_range)
            tmin = np.where(valid, tmin, np.inf)
            cur = t_grid[:, cols]
            upd = tmin < cur
            t_grid[:, cols] = np.where(upd, tmin, cur)
            sig_grid[:, cols] = np.where(upd, rough_n[b], sig_grid[:, cols])
        t_hit = t_grid.reshape(-1)
        sigma = sig_grid.reshape(-1)
    ok = (t_hit > min_range) & (t_hit < max_range)
    r = t_hit[ok]
    sig = sigma[ok]
    pts = d_s[ok] * r[:, None]
    if len(pts) > max_points:
        sel = rng.choice(len(pts), size=max_points, replace=False)
        pts, r, sig = pts[sel], r[sel], sig[sel]
    if len(pts):
        # radial range noise (real LiDAR noise is along the beam; foliage
        # hits carry their box's extra shell sigma)
        eps = rng.normal(size=len(pts)) * np.sqrt(noise * noise + sig * sig)
        pts = pts * (1.0 + eps / r)[:, None]
    return pts.astype(np.float32)


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
    """Urban-corridor BoxWorld: buildings lining the trajectory + street
    clutter + moving boxes. ``closed_loop=True`` drives the circular
    loop trajectory of :func:`make_loop_world` instead of the smooth
    wander (for loop-closure / long-horizon validation)."""
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
    # buildings: anchored left/right of the path every few metres, forming
    # a corridor (what makes real urban sweeps dense — most azimuths hit a
    # wall within range); gaps + size jitter keep geometry non-degenerate
    boxes = []
    path = poses[:, :3, 3]
    step = max(1, int(6.0 / max(speed * dt * 10, 1e-6)))
    for t in range(0, n_frames, step):
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        for side in (-1.0, 1.0):
            if rng.uniform() < 0.15:
                continue  # street gap / intersection
            off = corridor + rng.uniform(0.0, 10.0)
            size = np.array([rng.uniform(5, 14), rng.uniform(5, 14),
                             rng.uniform(5, 18)])
            c = path[t] + side * off * left + fwd * rng.uniform(-3, 3)
            boxes.append([c[0], c[1], size[2] / 2, *size])
    # Street-level clutter is what fills a real urban sweep: with a +2 deg
    # top beam, everything above ~2-3 m is out of FOV past a few metres,
    # so scan density comes from cars, fences/hedges, poles and ground —
    # not building height. Densities below reproduce a KITTI-class
    # voxeled cloud (~25-35k pts at 0.25 m) from the ray-cast sweep.
    path_len = max(speed * dt * 10 * n_frames, 1.0)
    # parked cars / vans lining both sides
    for _ in range(int(path_len * 1.0)):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        c = (path[t] + rng.uniform(4.0, corridor * 0.9) * left
             * (1 if rng.uniform() < 0.5 else -1) + fwd * rng.uniform(-8, 8))
        size = np.array([rng.uniform(3.2, 5.2), rng.uniform(1.6, 2.1),
                         rng.uniform(1.3, 2.1)])
        boxes.append([c[0], c[1], size[2] / 2, *size])
    # fences / hedges: long thin runs parallel to the street
    for _ in range(int(path_len / 9.0) + 2):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        side = 1 if rng.uniform() < 0.5 else -1
        c = path[t] + side * rng.uniform(5.0, corridor) * left \
            + fwd * rng.uniform(-6, 6)
        length = rng.uniform(6, 18)
        size = np.array([length, rng.uniform(0.2, 0.8), rng.uniform(0.8, 1.6)])
        # axis-aligned boxes only: orient roughly along the street by
        # swapping extents when the street runs closer to the y axis
        if abs(fwd[1]) > abs(fwd[0]):
            size = size[[1, 0, 2]]
        boxes.append([c[0], c[1], size[2] / 2, *size])
    # poles / bins / pedestrians-stature statics
    for _ in range(int(path_len * 0.6)):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        c = (path[t] + rng.uniform(-corridor, corridor) * left
             + fwd * rng.uniform(-8, 8))
        size = np.array([rng.uniform(0.2, 0.9), rng.uniform(0.2, 0.9),
                         rng.uniform(0.8, 3.0)])
        boxes.append([c[0], c[1], size[2] / 2, *size])
    rough = [0.0] * len(boxes)
    # trees: trunk + diffuse canopy on the verges. Canopies are what fill
    # the upper beams of a +-16.6 deg sensor at range — and their returns
    # are a noisy shell (rough sigma), not a crisp plane
    for _ in range(int(path_len / 5.0) + 2):
        t = rng.integers(n_frames)
        fwd = poses[t, :3, 0]
        left = np.array([-fwd[1], fwd[0], 0.0])
        side = 1 if rng.uniform() < 0.5 else -1
        c = path[t] + side * rng.uniform(5.0, corridor + 6.0) * left \
            + fwd * rng.uniform(-5, 5)
        trunk_h = rng.uniform(1.8, 3.5)
        trunk = np.array([rng.uniform(0.2, 0.5), rng.uniform(0.2, 0.5),
                          trunk_h])
        boxes.append([c[0], c[1], trunk_h / 2, *trunk])
        rough.append(0.0)
        canopy = np.array([rng.uniform(3.0, 7.5), rng.uniform(3.0, 7.5),
                           rng.uniform(2.5, 5.5)])
        boxes.append([c[0] + rng.uniform(-0.5, 0.5),
                      c[1] + rng.uniform(-0.5, 0.5),
                      trunk_h + canopy[2] / 2, *canopy])
        rough.append(rng.uniform(0.05, 0.12))
    world = BoxWorld(
        boxes=np.asarray(boxes, np.float32),
        poses=poses, stamps=stamps,
        rough=np.asarray(rough, np.float32),
    )
    if n_dynamic:
        dyn, vel = [], []
        for _ in range(n_dynamic):
            t = rng.integers(n_frames)
            c = path[t] + np.array([rng.uniform(-10, 10),
                                    rng.uniform(-10, 10), 0.0])
            size = np.array([rng.uniform(1.5, 4.0), rng.uniform(1.2, 2.0),
                             rng.uniform(1.2, 1.8)])
            a = rng.uniform(0, 2 * np.pi)
            v = rng.uniform(0.5, 2.0) * np.array([np.cos(a), np.sin(a), 0.0])
            dyn.append([c[0], c[1], size[2] / 2, *size])
            vel.append(v)
        world.dynamic_boxes = np.asarray(dyn, np.float32)
        world.dynamic_vel = np.asarray(vel, np.float32)
    return world
