"""Synthetic LiDAR worlds and scan generators (host-side, numpy).

The parts of the JAX package's ``io/synthetic.py`` that drive the port: the
urban-corridor :class:`BoxWorld`, the OS1-64 :class:`BeamModel` and the
exact ray-cast renderer (``chip_smoke.py``, the CLI's ``--synthetic``), and
the point-soup :class:`SyntheticWorld` with its wandering world
(:func:`make_world`, the world of ``tools_torch/scaling_bench.py``), its
moving boxes (:func:`add_dynamic_boxes`), its closed-loop world,
:func:`render_scan` and :func:`dump_kitti` (the CLI's ``--kitti`` path,
tested on a dumped sequence), and :func:`make_imu_between` (gyro and
accel samples from the ground truth, for the IMU path). They are copied,
not imported, because importing any module of the JAX package runs that
package's ``__init__``; ``tests/test_torch_io.py``,
``tests/test_torch_cli.py`` and ``tests/test_torch_imu.py`` check that both
copies produce identical worlds, scans and samples from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SyntheticWorld:
    surface_points: np.ndarray  # [M, 3] dense point soup on surfaces (world frame)
    poses: np.ndarray           # [T, 4, 4] ground-truth sensor poses
    stamps: np.ndarray          # [T] seconds
    # optional dynamic objects: points at t=0 plus a constant world-frame
    # velocity per point (moving boxes). They occlude and are occluded like
    # static surfaces but violate the static-world assumption every
    # odometry pipeline makes — the realism stressor real sequences carry.
    dynamic_points: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))
    dynamic_vel: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32))


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


def _box_surface(rng, center, size, density):
    """Sample points on the faces of an axis-aligned box."""
    cx, cy, cz = center
    sx, sy, sz = size
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    counts = np.maximum((areas * density).astype(int), 1)
    pts = []
    for face, n in enumerate(counts):
        u = rng.uniform(-0.5, 0.5, size=(n, 2))
        if face < 2:  # +x / -x
            x = np.full(n, 0.5 if face == 0 else -0.5)
            p = np.stack([x, u[:, 0], u[:, 1]], axis=1)
        elif face < 4:
            y = np.full(n, 0.5 if face == 2 else -0.5)
            p = np.stack([u[:, 0], y, u[:, 1]], axis=1)
        else:
            z = np.full(n, 0.5 if face == 4 else -0.5)
            p = np.stack([u[:, 0], u[:, 1], z], axis=1)
        pts.append(p * np.array(size) + np.array(center))
    return np.concatenate(pts, axis=0)


def make_world(
    rng: np.random.Generator,
    n_frames: int = 50,
    extent: float = 60.0,
    n_boxes: int = 40,
    density: float = 60.0,
    speed: float = 1.2,
    dt: float = 0.1,
    yaw_rate: float = 0.04,
    ground_points: int = 40000,
) -> SyntheticWorld:
    """Build a world and a smooth wandering trajectory through it.

    NOTE on scan overlap: consecutive scans rendered from this world see
    the *same* surface points (plus noise) wherever their ranges overlap —
    like a real LiDAR densely sampling continuous surfaces. Keep the world
    dense enough (ground_points/density vs extent) that
    :func:`render_scan`'s ``max_points`` does NOT force random
    subsampling, otherwise scans become near-disjoint sparse subsets and
    scan-to-map matching at realistic radii breaks down.
    """
    surf = [
        # ground plane as a thin grid of points
        np.stack(
            [
                rng.uniform(-extent, extent, size=ground_points),
                rng.uniform(-extent, extent, size=ground_points),
                np.zeros(ground_points),
            ],
            axis=1,
        )
    ]
    for _ in range(n_boxes):
        center = [
            rng.uniform(-extent * 0.9, extent * 0.9),
            rng.uniform(-extent * 0.9, extent * 0.9),
            rng.uniform(1.0, 4.0),
        ]
        size = rng.uniform(1.0, 8.0, size=3)
        surf.append(_box_surface(rng, center, size, density))
    surface_points = np.concatenate(surf, axis=0).astype(np.float32)

    # smooth trajectory: constant speed, AR(1) yaw rate (white-noise yaw
    # produces 20deg+ single-frame jumps that alias scan matching without
    # an IMU prior — real platforms turn smoothly), sensor 1.5m up
    poses = np.zeros((n_frames, 4, 4))
    stamps = np.arange(n_frames) * dt
    yaw = 0.0
    yaw_vel = 0.0
    pos = np.array([0.0, 0.0, 1.5])
    for t in range(n_frames):
        yaw_vel = 0.8 * yaw_vel + rng.normal(scale=yaw_rate)
        yaw_vel = np.clip(yaw_vel, -0.09, 0.09)  # <= ~5 deg/frame, 10 Hz realistic
        yaw += yaw_vel * dt * 10
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[t] = np.eye(4)
        poses[t, :3, :3] = R
        poses[t, :3, 3] = pos
        pos = pos + R @ np.array([speed * dt * 10, 0, 0])
    return SyntheticWorld(surface_points=surface_points, poses=poses, stamps=stamps)


def add_dynamic_boxes(
    world: SyntheticWorld,
    rng: np.random.Generator,
    n: int = 2,
    density: float = 60.0,
    speed: float = 1.5,
    offset: float = 10.0,
) -> SyntheticWorld:
    """Scatter ``n`` moving boxes (cars/pedestrians class) near the path.

    Each box is placed within ``offset`` m of a random trajectory pose so
    the sensor actually sees it, and drifts at up to ``speed`` m/s along a
    random ground-plane heading. Points violate the static-world
    assumption — the odometry must reject them as outliers (real
    sequences are full of them).
    """
    pts, vels = [], []
    for _ in range(n):
        anchor = world.poses[rng.integers(len(world.poses)), :3, 3]
        center = anchor + np.array([
            rng.uniform(-offset, offset), rng.uniform(-offset, offset),
            rng.uniform(0.5, 1.5) - anchor[2],
        ])
        size = rng.uniform(0.8, 3.5, size=3)
        p = _box_surface(rng, center, size, density)
        a = rng.uniform(0, 2 * np.pi)
        v = speed * rng.uniform(0.3, 1.0) * np.array([np.cos(a), np.sin(a), 0.0])
        pts.append(p)
        vels.append(np.tile(v, (len(p), 1)))
    return SyntheticWorld(
        surface_points=world.surface_points,
        poses=world.poses,
        stamps=world.stamps,
        dynamic_points=np.concatenate(pts, axis=0).astype(np.float32),
        dynamic_vel=np.concatenate(vels, axis=0).astype(np.float32),
    )


def make_loop_world(
    rng: np.random.Generator,
    n_frames: int = 500,
    speed: float = 0.4,
    dt: float = 0.1,
    z_amplitude: float = 1.0,
    n_loops: float = 1.0,
    density: float = 6.0,
    ground_density: float = 9.0,
) -> SyntheticWorld:
    """Closed-loop trajectory with elevation — the hard validation world.

    The sensor travels a circle of circumference ``speed * n_frames /
    n_loops`` (heading tangent to it, like a vehicle) while bobbing
    ``z_amplitude`` metres sinusoidally — exercising loop closure, z
    drift, and pitch-free elevation change over arbitrarily long
    sequences. The world (ground plane + boxes) is sized to the loop so
    500+ frame runs never exit the populated region. Surface sampling is
    ~0.3 m so scan matching stays in the ICP basin.
    """
    radius = speed * n_frames / n_loops / (2 * np.pi)
    extent = radius + 16.0  # loop + scan range margin
    ground_points = int(ground_density * (2 * extent) ** 2)  # pts per m^2
    # boxes scattered in an annulus around the loop path so every frame
    # sees vertical structure (pure ground is yaw-unobservable)
    n_boxes = max(8, int(radius * 1.5))
    surf = [
        np.stack(
            [
                rng.uniform(-extent, extent, size=ground_points),
                rng.uniform(-extent, extent, size=ground_points),
                np.zeros(ground_points),
            ],
            axis=1,
        )
    ]
    for k in range(n_boxes):
        a = 2 * np.pi * k / n_boxes + rng.uniform(-0.2, 0.2)
        rr = radius + rng.uniform(-8.0, 8.0)
        center = [rr * np.cos(a), rr * np.sin(a), rng.uniform(1.0, 4.0)]
        size = rng.uniform(1.0, 8.0, size=3)
        surf.append(_box_surface(rng, center, size, density))
    surface_points = np.concatenate(surf, axis=0).astype(np.float32)

    poses = np.zeros((n_frames, 4, 4))
    stamps = np.arange(n_frames) * dt
    for t in range(n_frames):
        a = 2 * np.pi * n_loops * t / n_frames
        c, s = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)  # tangent heading
        poses[t] = np.eye(4)
        poses[t, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[t, :3, 3] = [
            radius * np.cos(a),
            radius * np.sin(a),
            1.5 + z_amplitude * np.sin(2 * a),
        ]
    return SyntheticWorld(
        surface_points=surface_points, poses=poses, stamps=stamps
    )


def dump_kitti(
    world: SyntheticWorld,
    root: str,
    sequence: str = "00",
    rng: np.random.Generator | None = None,
    max_range: float = 13.0,
    max_points: int = 8192,
    beams: BeamModel | None = None,
) -> str:
    """Write a synthetic world as a KITTI odometry sequence directory.

    Produces ``root/sequences/<seq>/velodyne/NNNNNN.bin`` (float32 xyzi
    rows — intensity synthesized as 1/range, a crude lambertian),
    ``times.txt``, and ``root/poses/<seq>.txt``, the exact layout
    :func:`io.kitti.load_sequence` reads — so the full CLI ``--kitti``
    path is testable without the real dataset. ``beams``: render through
    that beam model (:func:`render_scan`); None keeps the point-soup
    renderer. Returns ``root``.
    """
    import os

    rng = rng or np.random.default_rng(0)
    vdir = os.path.join(root, "sequences", sequence, "velodyne")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    n = len(world.poses)
    for t in range(n):
        xyz = render_scan(world, t, rng, max_range=max_range,
                          max_points=max_points, beams=beams)
        r = np.maximum(np.linalg.norm(xyz, axis=1), 1.0)
        xyzi = np.concatenate([xyz, (1.0 / r)[:, None]], axis=1)
        xyzi.astype(np.float32).tofile(
            os.path.join(vdir, f"{t:06d}.bin")
        )
    np.savetxt(os.path.join(root, "sequences", sequence, "times.txt"),
               world.stamps, fmt="%.6f")
    np.savetxt(os.path.join(root, "poses", f"{sequence}.txt"),
               world.poses[:, :3, :4].reshape(n, 12), fmt="%.9f")
    return root


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


_CELL = 32.0  # metres; xy-cell size of the lazy render prefilter grid


def _candidates_near(
    world: SyntheticWorld, center: np.ndarray, max_range: float
) -> np.ndarray:
    """Static surface points within max_range of center, by xy-cell grid.

    World sizes scale with sequence length (bench worlds reach millions of
    points) while each scan only sees a ~max_range disc, so the renderer
    prefilters through a lazily built cell index cached on the world
    (rebuilt if surface_points is replaced).
    """
    pts = world.surface_points
    cache = getattr(world, "_cell_cache", None)
    if cache is None or cache[0] is not pts:
        ids = np.floor(pts[:, :2] / _CELL).astype(np.int64)
        order = np.lexsort((ids[:, 1], ids[:, 0]))
        sids = ids[order]
        change = np.ones(len(sids), bool)
        change[1:] = np.any(sids[1:] != sids[:-1], axis=1)
        starts = np.flatnonzero(change)
        keys = [tuple(k) for k in sids[starts]]
        ends = np.append(starts[1:], len(sids))
        table = {k: (s, e) for k, s, e in zip(keys, starts, ends)}
        cache = (pts, order, table)
        object.__setattr__(world, "_cell_cache", cache)
    _, order, table = cache
    lo = np.floor((center[:2] - max_range) / _CELL).astype(np.int64)
    hi = np.floor((center[:2] + max_range) / _CELL).astype(np.int64)
    slices = []
    for ix in range(lo[0], hi[0] + 1):
        for iy in range(lo[1], hi[1] + 1):
            se = table.get((ix, iy))
            if se is not None:
                slices.append(order[se[0]:se[1]])
    if not slices:
        return pts[:0]
    return pts[np.concatenate(slices)]


def render_scan(
    world: SyntheticWorld,
    frame: int,
    rng: np.random.Generator,
    max_range: float = 40.0,
    min_range: float = 0.5,
    max_points: int = 8192,
    noise: float = 0.01,
    beams: BeamModel | None = None,
) -> np.ndarray:
    """Points visible from pose[frame], in the sensor frame. [<=max_points, 3].

    ``beams=None`` is the legacy point-soup renderer (range gating only —
    every surface point within range is returned, through walls). Passing
    a :class:`BeamModel` renders an occluded spinning-scanner sweep: the
    nearest return per (beam, azimuth) bin after a min-pooled z-buffer
    occlusion test, with radial range noise. Dynamic objects (if the
    world has any) are advanced to ``stamps[frame]`` and rendered too.
    A :class:`BoxWorld` dispatches to the exact ray-cast renderer.
    """
    if isinstance(world, BoxWorld):
        return render_raycast(
            world, frame, rng, max_range=max_range, min_range=min_range,
            max_points=max_points, noise=noise, beams=beams)
    T = world.poses[frame]
    pts_all = _candidates_near(world, T[:3, 3], max_range)
    if len(world.dynamic_points):
        t = float(world.stamps[frame])
        dyn = world.dynamic_points + world.dynamic_vel * t
        pts_all = np.concatenate([pts_all, dyn.astype(np.float32)], axis=0)
    # f32 throughout: a float64 T would promote every elementwise op on the
    # candidate set (hundreds of k points per frame) to double width
    rel = pts_all - T[:3, 3].astype(np.float32)
    r = np.sqrt(np.einsum("ij,ij->i", rel, rel))
    vis = (r < max_range) & (r > min_range)
    if beams is None:
        pts_w = pts_all[vis]
        if len(pts_w) > max_points:
            sel = rng.choice(len(pts_w), size=max_points, replace=False)
            pts_w = pts_w[sel]
        # world -> sensor
        pts_s = (pts_w - T[:3, 3]) @ T[:3, :3]
        pts_s = pts_s + rng.normal(scale=noise, size=pts_s.shape)
        return pts_s.astype(np.float32)

    # --- occluded spinning-scanner sweep -------------------------------
    # sensor-frame directions (beam pattern is a property of the sensor)
    rel_s = rel[vis] @ T[:3, :3].astype(np.float32)
    r = r[vis]
    el = np.arcsin(np.clip(rel_s[:, 2] / r, -1.0, 1.0))
    lo, hi = np.deg2rad(beams.fov_down_deg), np.deg2rad(beams.fov_up_deg)
    in_fov = (el >= lo) & (el < hi)
    rel_s, r, el = rel_s[in_fov], r[in_fov], el[in_fov]
    az = np.arctan2(rel_s[:, 1], rel_s[:, 0])  # [-pi, pi)
    ia = np.minimum(
        ((az + np.pi) * (beams.n_azimuth / (2 * np.pi))).astype(np.int64),
        beams.n_azimuth - 1,
    )
    ie = np.minimum(
        ((el - lo) * (beams.n_beams / (hi - lo))).astype(np.int64),
        beams.n_beams - 1,
    )
    bins = ie * beams.n_azimuth + ia
    # one sort serves the z-buffer, the occlusion test, and the return
    # selection: within each bin group points come nearest-first
    order = np.lexsort((r, bins))
    b_s, r_s = bins[order], r[order].astype(np.float32)
    first = np.ones(len(b_s), bool)
    first[1:] = b_s[1:] != b_s[:-1]
    zbuf = np.full(beams.n_beams * beams.n_azimuth, np.inf, np.float32)
    zbuf[b_s[first]] = r_s[first]  # nearest range per bin
    # min-pool the z-buffer over azimuth neighbors only (azimuth wraps;
    # elevation pooling would self-cull grazing surfaces — see BeamModel)
    zg = zbuf.reshape(beams.n_beams, beams.n_azimuth)
    if beams.occl_pool > 0:
        pooled = zg.copy()
        for da in range(1, beams.occl_pool + 1):
            np.minimum(pooled, np.roll(zg, da, axis=1), out=pooled)
            np.minimum(pooled, np.roll(zg, -da, axis=1), out=pooled)
        occ_min = pooled.reshape(-1)
    else:
        occ_min = zbuf
    keep = r_s <= occ_min[b_s] + beams.occl_slack_abs + beams.occl_slack_rel * r_s
    # one return per bin: the nearest surviving point of each bin group
    idx = np.flatnonzero(keep)
    bk = b_s[idx]
    fk = np.ones(len(bk), bool)
    fk[1:] = bk[1:] != bk[:-1]
    sel = order[idx[fk]]
    pts_s = rel_s[sel]
    r = r[sel]
    if len(pts_s) > max_points:
        sub = rng.choice(len(pts_s), size=max_points, replace=False)
        pts_s, r = pts_s[sub], r[sub]
    # radial range noise (real LiDAR noise is along the beam)
    pts_s = pts_s * (1.0 + rng.normal(scale=noise, size=len(pts_s)) / r)[:, None]
    return pts_s.astype(np.float32)


def make_imu_between(
    world: SyntheticWorld, frame: int, rate_hz: float, rng, gyro_noise=0.002,
    gyro_bias=np.zeros(3),
):
    """Synthesize gyro samples between frame-1 and frame from ground truth.

    Returns [S, 7] rows of (stamp, wx, wy, wz, ax, ay, az) in the body frame,
    mirroring the reference's ImuMeas layout (odom.h:151-164).
    """
    if frame == 0:
        return np.zeros((0, 7))
    t0, t1 = world.stamps[frame - 1], world.stamps[frame]
    n = max(int((t1 - t0) * rate_hz), 2)
    ts = np.linspace(t0, t1, n)
    R0 = world.poses[frame - 1][:3, :3]
    R1 = world.poses[frame][:3, :3]
    # constant body angular velocity over the interval: w = log(R0^T R1)/dt
    dR = R0.T @ R1
    cos_t = np.clip((np.trace(dR) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-9:
        w = np.zeros(3)
    else:
        w = (
            theta
            / (2 * np.sin(theta))
            * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
        ) / (t1 - t0)
    out = np.zeros((n, 7))
    out[:, 0] = ts
    out[:, 1:4] = w + gyro_bias + rng.normal(scale=gyro_noise, size=(n, 3))
    # specific force for slow platforms ~= gravity reaction in the BODY
    # frame (R^T g z-hat): a tilted body reads tilted gravity, which is
    # what gravity alignment (odom.cc:535-579) consumes
    out[:, 4:7] = R0.T @ np.array([0, 0, 9.81])
    return out
