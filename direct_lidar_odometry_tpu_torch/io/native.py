"""ctypes binding of the native host library (``cpp/dlo_host.cpp``).

Counterpart of the JAX package's ``io/native.py``: KITTI scan reading,
NaN/crop/voxel preprocessing (plain and Morton-ordered), the uint16
wire-format encoder and a background scan prefetcher, all in threaded C++
that releases the GIL.

At first use, ``g++`` compiles ``cpp/dlo_host.cpp`` (the flags of
``cpp/Makefile``) into ``_build/host/`` next to this package (listed in
``.gitignore``); the library file is named by a hash of the source and the
flags, so an edit rebuilds and an unchanged tree reuses the last build, and
a file lock keeps concurrent processes from building it twice. Nothing is
written into ``cpp/``. When the compiler or the loader fails,
:func:`available` is False and :func:`load_error` returns its message;
callers then take their numpy paths (``io/hostprep.py``,
``core/cloud.py``), and the functions below raise with that message.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from direct_lidar_odometry_tpu_torch.utils import sync

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "cpp" / "dlo_host.cpp"
BUILD_DIR = _PKG / "_build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_F = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "dlo_read_velodyne": (ctypes.c_int64, [ctypes.c_char_p, _F, ctypes.c_int64]),
    "dlo_preprocess": (ctypes.c_int64, [_F, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                                        _F, ctypes.c_int64]),
    "dlo_preprocess_morton": (ctypes.c_int64, [_F, ctypes.c_int64, ctypes.c_float,
                                               ctypes.c_float, _F, ctypes.c_int64]),
    "dlo_quantize": (ctypes.c_int64, [_F, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint16), _F, _F]),
    "dlo_feeder_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                                            ctypes.c_int64]),
    "dlo_feeder_next": (ctypes.c_int64, [ctypes.c_void_p, _F]),
    "dlo_feeder_destroy": (None, [ctypes.c_void_p]),
}

_state: dict = {}  # "lib" or "error", set by the first _load()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdlo_host_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if this source has none yet; raise on failure
    with the compiler's message. Returns (library path, seconds spent
    compiling; 0.0 when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _library_path()
    if lib.exists():
        return lib, 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    # the lock is released when the file closes
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, 0.0
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, lib)
        return lib, seconds


def _load():
    if not _state:
        try:
            lib = ctypes.CDLL(str(build()[0]))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _state["lib"] = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _state["error"] = f"{type(e).__name__}: {e}"
    return _state.get("lib")


def available() -> bool:
    """True when the library built and loaded (the first call builds it)."""
    return _load() is not None


def load_error() -> str | None:
    """The compiler's or the loader's message when :func:`available` is False."""
    _load()
    return _state.get("error")


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {_state['error']}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def read_velodyne(path: str, max_points: int = 1 << 20) -> np.ndarray:
    """[N, 3] xyz of a KITTI ``.bin`` scan (the intensity column dropped)."""
    out = np.empty((max_points, 3), np.float32)
    n = _lib().dlo_read_velodyne(path.encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return out[:n].copy()


def preprocess(
    points: np.ndarray, crop_size: float = 1.0, res: float = 0.25, out_cap: int = 1 << 17,
) -> np.ndarray:
    """NaN + inverse-crop + centroid voxel filter (``res <= 0``: no voxel)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.empty((out_cap, 3), np.float32)
    n = _lib().dlo_preprocess(_fptr(pts), len(pts), ctypes.c_float(crop_size),
                              ctypes.c_float(res), _fptr(out), out_cap)
    return out[:n].copy()


def preprocess_morton(points: np.ndarray, crop_size: float, res: float, out_cap: int) -> np.ndarray:
    """NaN + inverse-crop + centroid voxel filter, Z-ordered output: the
    host twin of ``ops.voxel.voxel_downsample_morton`` (same voxels, same
    Morton order, same Bresenham overflow)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.empty((out_cap, 3), np.float32)
    n = _lib().dlo_preprocess_morton(_fptr(pts), len(pts), ctypes.c_float(crop_size),
                                     ctypes.c_float(res), _fptr(out), out_cap)
    return out[:n].copy()


def quantize(points: np.ndarray, capacity: int):
    """uint16 wire-format encode (``core/cloud.py`` ``QuantizedScan``):
    (q [capacity, 3] u16, lo [3] f32, scale [3] f32, count int32)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    q = np.empty((capacity, 3), np.uint16)
    lo = np.empty(3, np.float32)
    scale = np.empty(3, np.float32)
    m = _lib().dlo_quantize(_fptr(pts), len(pts), capacity,
                            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                            _fptr(lo), _fptr(scale))
    return q, lo, scale, np.int32(m)


class ScanFeeder:
    """Background scan prefetcher over a list of ``.bin`` files: iterates
    (index, [N, 3] points) with the reads (and, with ``res > 0``, the
    voxel filter) running ``depth`` scans ahead of the consumer. Raises
    ``IOError`` at a scan that cannot be read."""

    def __init__(self, files: list[str], cap: int = 1 << 17, crop_size: float = 1.0,
                 res: float = 0.25, depth: int = 4):
        self._lib = _lib()
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._handle = self._lib.dlo_feeder_create(
            arr, len(files), cap, ctypes.c_float(crop_size), ctypes.c_float(res), depth)
        self._buf = np.empty((cap, 3), np.float32)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        n = self._lib.dlo_feeder_next(self._handle, _fptr(self._buf))
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError(f"scan {self._i} failed to read")
        i = self._i
        self._i += 1
        sync.count("feeder_scans")  # scans served (the CLI's KITTI path reports it)
        return i, self._buf[:n].copy()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dlo_feeder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
