"""Trajectory writers (KITTI / TUM formats).

The reference keeps the trajectory only in RAM (``odom.h:80-82``) and
publishes poses over ROS; here trajectories are first-class artifacts for
offline evaluation and checkpointing.

A numpy copy of the JAX package's ``io/trajectory.py`` (importing any module of
that package runs its ``__init__``, which imports jax);
``tests/test_torch_cli.py`` checks that the two read and write the same
files.
"""

from __future__ import annotations

import numpy as np


def write_kitti(path: str, poses: np.ndarray) -> None:
    """poses: [T, 4, 4] -> KITTI odometry format (3x4 row-major per line)."""
    with open(path, "w") as f:
        for T in poses:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def read_kitti(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


def continuous_quats(rotations: np.ndarray) -> np.ndarray:
    """Quaternions (xyzw) for a rotation sequence with sign continuity.

    q and -q encode the same rotation; matrix->quaternion conversion picks
    an arbitrary hemisphere per frame, so a smooth trajectory can emit sign
    jumps that break downstream interpolation/plotting. The reference flips
    the current quaternion when its dot with the previous one is negative
    (``odom.cc:334-346``); same rule here, applied over the whole sequence
    with a cumulative sign so each frame is continuous with its predecessor.
    """
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(rotations).as_quat()  # [T, 4] xyzw
    if len(q) > 1:
        dots = np.sum(q[1:] * q[:-1], axis=-1)
        signs = np.cumprod(np.where(dots < 0.0, -1.0, 1.0))
        q[1:] *= signs[:, None]
    return q


def write_tum(path: str, stamps: np.ndarray, poses: np.ndarray) -> None:
    """TUM format: stamp tx ty tz qx qy qz qw (sign-continuous quaternions)."""
    q = continuous_quats(poses[:, :3, :3])
    with open(path, "w") as f:
        for t, T, qi in zip(stamps, poses, q):
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}\n")
