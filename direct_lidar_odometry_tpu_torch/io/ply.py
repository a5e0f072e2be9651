"""Minimal binary PLY point-cloud writer/reader for map export.

The reference publishes its map as a ROS PointCloud2 for RViz
(``map.cc:100-114``); offline, PLY is the interoperable equivalent
(CloudCompare/meshlab/Open3D all read it). Clouds with a 4th column are
written with an ``intensity`` property (PointXYZI parity, ``dlo/dlo.h:50``).

A numpy copy of the JAX package's ``io/ply.py`` (importing any module of
that package runs its ``__init__``, which imports jax);
``tests/test_torch_cli.py`` checks that the two read and write the same
files.
"""

from __future__ import annotations

import numpy as np

_HEADER_XYZ = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
end_header
"""

_HEADER_XYZI = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
property float intensity
end_header
"""


def write_ply(path: str, points: np.ndarray) -> None:
    """[N, 3] xyz or [N, 4] xyzi -> binary little-endian PLY."""
    c = 4 if points.shape[1] >= 4 else 3
    points = np.ascontiguousarray(points[:, :c], dtype="<f4")
    header = _HEADER_XYZI if c == 4 else _HEADER_XYZ
    with open(path, "wb") as f:
        f.write(header.format(n=len(points)).encode())
        f.write(points.tobytes())


def read_ply(path: str) -> np.ndarray:
    """Returns [N, 3] or [N, 4] depending on the stored properties."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        n = int(
            [ln for ln in lines if ln.startswith("element vertex")][0].split()[-1]
        )
        c = sum(1 for ln in lines if ln.startswith("property float"))
        return (
            np.frombuffer(f.read(n * 4 * c), dtype="<f4").reshape(n, c).copy()
        )
