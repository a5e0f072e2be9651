"""A route that revisits: four circular petals through one hub.

Each petal is the closed-loop box world of :func:`world.make_urban_world`
(a circle of ``petal_frames`` frames, buildings, cars, fences, poles and
trees along it), moved so that it starts at the hub, and turned a quarter
turn from the petal before; the petals are driven one after the other and
the route ends back at the hub (``petals * petal_frames + 1`` frames).
Each petal is new ground; each closes at the hub, and the circles of
neighbouring petals cross a second time. The sensor turns the quarter at
the hub between two frames, which the gyro follows.

Every static box whose footprint comes within half the corridor of a route
pose is taken out, so that no box stands on any petal's road. Quarter
turns keep the boxes axis-aligned.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import world as bw

# cos and sin of p quarter turns, exact
_COS = (1, 0, -1, 0)
_SIN = (0, 1, 0, -1)


def _turn(p: int) -> np.ndarray:
    c, s = _COS[p % 4], _SIN[p % 4]
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _move_boxes(boxes: np.ndarray, shift: np.ndarray, p: int) -> np.ndarray:
    """Axis-aligned boxes [B, 6] shifted, then turned ``p`` quarter turns
    about the origin (x and y sizes swap on odd turns)."""
    out = np.array(boxes, dtype=np.float64).reshape(-1, 6)
    out[:, :3] = (out[:, :3] + shift) @ _turn(p).T
    if p % 2:
        out[:, [3, 4]] = out[:, [4, 3]]
    return out


def off_road(boxes: np.ndarray, route_xy: np.ndarray, half_width: float) -> np.ndarray:
    """[B] whether each box's footprint lies at least ``half_width`` from
    every route position."""
    if not len(boxes):
        return np.zeros(0, bool)
    lo = boxes[:, None, :2] - boxes[:, None, 3:5] / 2
    hi = boxes[:, None, :2] + boxes[:, None, 3:5] / 2
    gap = np.maximum(np.maximum(lo - route_xy[None], route_xy[None] - hi), 0.0)
    return np.linalg.norm(gap, axis=-1).min(axis=1) >= half_width


def build_cloverleaf(world_cfg: dict, route: dict, seq: np.random.SeedSequence) -> bw.BoxWorld:
    """The route of ``route`` (``petals``, ``petal_frames``) in the
    configuration's world (its ``world`` block), the petals' worlds drawn
    from ``seq``."""
    speed = world_cfg["speed_m_per_frame"]
    n = route["petal_frames"]
    radius = speed * n / (2 * np.pi)
    shift = np.array([-radius, 0.0, 0.0])
    n_dyn = max(world_cfg["dynamic_min"], n // world_cfg["dynamic_per_frames"])
    poses, boxes, rough, dyn, vel = [], [], [], [], []
    for p, child in enumerate(seq.spawn(route["petals"])):
        w = bw.make_urban_world(np.random.default_rng(child), n_frames=n, speed=speed,
                                corridor=world_cfg["corridor_m"], n_dynamic=n_dyn,
                                closed_loop=True)
        move = np.eye(4)
        move[:3, :3] = _turn(p)
        move[:3, 3] = _turn(p) @ shift
        poses.append(move @ w.poses)
        boxes.append(_move_boxes(w.boxes, shift, p))
        rough.append(w.rough)
        dyn.append(_move_boxes(w.dynamic_boxes, shift, p))
        vel.append(np.asarray(w.dynamic_vel, np.float64).reshape(-1, 3) @ _turn(p).T)
    poses.append(poses[-1][:1])  # back at the hub
    poses = np.concatenate(poses)
    poses[:, 2, 3] += world_cfg["sensor_height_m"] - 1.5
    boxes, rough = np.concatenate(boxes), np.concatenate(rough)
    keep = off_road(boxes, poses[:, :2, 3], world_cfg["corridor_m"] / 2)
    world = bw.BoxWorld(boxes=boxes[keep].astype(np.float32), poses=poses,
                        stamps=np.arange(len(poses)) * 0.1, rough=rough[keep].astype(np.float32))
    world.dynamic_boxes = np.concatenate(dyn).astype(np.float32)
    world.dynamic_vel = np.concatenate(vel).astype(np.float32)
    return world
