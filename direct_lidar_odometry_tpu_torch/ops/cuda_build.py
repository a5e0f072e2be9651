"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every ``.cu`` file under ``csrc/`` (with
the shared device functions of ``csrc/*.cuh``) into one shared library
with a plain C interface, for ``sm_90a`` (Hopper), inside ``_build/``
next to this package (listed in ``.gitignore``). The library
file is named by a hash of the sources and the flags, so an edit rebuilds
and an unchanged tree reuses the last build; a file lock keeps concurrent
processes from building the same library twice. The library is bound with
``ctypes`` (every pointer and the stream as ``c_void_p``), so no PyTorch
header is compiled and a build takes seconds. A failed build raises with
nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see the extern "C" blocks)
_SIGNATURES = {
    "dlo_nn1_pruned": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    "dlo_nn1_pruned_mxu": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    "dlo_nn1_exhaustive": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "dlo_cov_pruned": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "dlo_cov_exhaustive": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P),
    "dlo_fused_linearize": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                            _P, _P, _P, _P),
}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if this source tree has no library yet.

    Returns (library path, seconds spent compiling; 0.0 when reused).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libdlo_kernels_{_source_key()}.so"
    if lib.exists():
        return lib, 0.0
    # the lock is released when the file closes
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, 0.0
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)) for cmd in cmds]
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib)
        return lib, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, loaded once per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
