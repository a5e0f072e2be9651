"""KITTI odometry dataset reader (Velodyne ``.bin`` scans + poses).

No KITTI data ships with the repository; this module is the loader for
real deployments and is tested against self-written files of the same
format (``io/synthetic.py`` ``dump_kitti``).

A numpy copy of the JAX package's ``io/kitti.py`` (importing any module of
that package runs its ``__init__``, which imports jax);
``tests/test_torch_cli.py`` checks that the two read and write the same
files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI Velodyne scan: float32 (x, y, z, intensity) rows -> [N, 4]."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth pose file -> [T, 4, 4]."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


def read_calib(path: str) -> dict[str, np.ndarray]:
    """KITTI calib.txt -> {key: [3, 4]}; 'Tr' maps velodyne -> cam0."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.fromstring(vals, sep=" ").reshape(3, 4)
    return out


@dataclass
class KittiSequence:
    """Lazy scan iterator over a KITTI odometry sequence directory."""

    velodyne_dir: str
    poses: np.ndarray | None = None
    stamps: np.ndarray | None = None

    def __post_init__(self):
        self.files = sorted(
            os.path.join(self.velodyne_dir, f)
            for f in os.listdir(self.velodyne_dir)
            if f.endswith(".bin")
        )
        if self.stamps is None:
            self.stamps = np.arange(len(self.files)) * 0.1  # 10 Hz

    def __len__(self) -> int:
        return len(self.files)

    def scan(self, i: int) -> np.ndarray:
        """[N, 3] xyz of scan i."""
        return read_velodyne_bin(self.files[i])[:, :3]

    def scan_xyzi(self, i: int) -> np.ndarray:
        """[N, 4] xyz + intensity of scan i (PointXYZI parity, dlo.h:50)."""
        return read_velodyne_bin(self.files[i])


def load_sequence(root: str, sequence: str) -> KittiSequence:
    """root/sequences/<seq>/velodyne + root/poses/<seq>.txt (if present)."""
    vdir = os.path.join(root, "sequences", sequence, "velodyne")
    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    poses = read_poses(pose_file) if os.path.exists(pose_file) else None
    ts_file = os.path.join(root, "sequences", sequence, "times.txt")
    stamps = np.loadtxt(ts_file) if os.path.exists(ts_file) else None
    return KittiSequence(velodyne_dir=vdir, poses=poses, stamps=stamps)
