"""Measure the CPU reference baseline (``cpp/dlo_baseline.cpp``) on the bench world.

Port of the JAX package's ``cpp/run_baseline.py``. Renders the sequence
``bench_torch.py`` measures (``make_bench_world`` from ``rng(0)``), dumps it
in the baseline's scan format, runs the from-scratch C++/OpenMP
reproduction of the reference pipeline on it and scores the trajectory
with the port's evaluator (unaligned ATE). Prints the binary's stats JSON
plus ``ate_rmse_m``: the denominator of ``bench_torch.py``.

    python3 tools_torch/run_baseline.py [--frames N] [--small] [--cv] [--threads N] [--thin N]

At first use, ``g++`` compiles ``cpp/dlo_baseline.cpp`` with the flags of
``cpp/Makefile`` into ``direct_lidar_odometry_tpu_torch/_build/baseline/``
(listed in ``.gitignore``); the binary is named by a hash of the source
and the flags, and a file lock keeps concurrent processes from building it
twice. Nothing is written into ``cpp/``. It runs on the host's CPU only.
"""

from __future__ import annotations

import argparse
import fcntl
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = REPO / "cpp" / "dlo_baseline.cpp"
BUILD_DIR = REPO / "direct_lidar_odometry_tpu_torch" / "_build" / "baseline"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-fopenmp")


def _binary_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"dlo_baseline_{h.hexdigest()[:16]}"


def build() -> tuple[Path, float]:
    """Compile the baseline if this source has no binary yet; raise on
    failure with the compiler's message. Returns (binary path, seconds
    spent compiling; 0.0 when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = _binary_path()
    if exe.exists():
        return exe, 0.0
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the CPU baseline cannot be built")
    # the lock is released when the file closes
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if exe.exists():
            return exe, 0.0
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, exe)
        return exe, seconds


def dump_scans(path: str, scans, stamps) -> None:
    """The baseline's input: b"DLOSCAN1", the frame count (int64), then per
    frame its stamp (float64), its point count (int64) and [N, 3] float32."""
    with open(path, "wb") as f:
        f.write(b"DLOSCAN1")
        f.write(struct.pack("<q", len(scans)))
        for s, t in zip(scans, stamps):
            f.write(struct.pack("<d", float(t)))
            f.write(struct.pack("<q", len(s)))
            f.write(np.ascontiguousarray(s, np.float32).tobytes())


def load_traj(path: str) -> np.ndarray:
    """The baseline's output: the frame count (int64), then per frame its
    stamp (float64) and a row-major 4x4 float32 pose. Returns [N, 4, 4]."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<q", f.read(8))
        out = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            f.read(8)  # stamp
            out[i] = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
    return out


def run(frames: int = 25, small: bool = False, cv: bool = False, threads: int = 0,
        thin: int = 0) -> dict:
    """The baseline's stats (frames, median_ms, mean_ms, fps, threads, thin)
    on ``frames`` frames of the bench world, plus ``ate_rmse_m``. ``cv``: a
    constant-velocity prior; ``threads``: OpenMP threads (0: the runtime's
    default); ``thin``: Morton-ordered uniform thinning of the voxeled scan
    to that many points (0: none)."""
    from bench_torch import make_bench_world
    from direct_lidar_odometry_tpu_torch.io import evaluation, synthetic

    exe, build_s = build()
    print(f"# baseline binary {exe.name} (built in {build_s:.2f} s); "
          f"{len(os.sched_getaffinity(0))} usable cores", file=sys.stderr)
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(frames, rng, small)
    scans = [synthetic.render_scan(world, t, rng, max_range=max_range, max_points=max_pts,
                                   beams=beams) for t in range(frames)]
    print(f"# {len(scans)} scans, mean {np.mean([len(s) for s in scans]):.0f} pts",
          file=sys.stderr)

    with tempfile.TemporaryDirectory() as d:
        sp, tp = os.path.join(d, "scans.bin"), os.path.join(d, "traj.bin")
        dump_scans(sp, scans, world.stamps)
        cmd = [str(exe)]
        if cv:
            cmd.append("--cv")
        if threads:
            cmd += ["--threads", str(threads)]
        if thin:
            cmd += ["--thin", str(thin)]
        cmd += [sp, tp]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for line in out.stderr.splitlines()[-3:]:
            print(line, file=sys.stderr)
        stats = json.loads(out.stdout.strip())
        est = load_traj(tp)

    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    ate = evaluation.ate(est.astype(np.float64), gt, align=False)
    stats["ate_rmse_m"] = round(float(ate.rmse), 4)
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cv", action="store_true")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--thin", type=int, default=0,
                    help="Morton-ordered uniform thinning of the voxeled scan to N points: "
                         "the budget cap the port's pipeline applies (same-work protocol)")
    args = ap.parse_args(argv)
    stats = run(args.frames, args.small, args.cv, args.threads, args.thin)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
