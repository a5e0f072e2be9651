"""Cross-process scaling efficiency: N OS processes, one sequence each.

Port of the JAX package's ``tools/scaling_procs.py``. It runs the sharded
multi-sequence step (``tools_torch/scaling_procs_worker.py``) over a real
``torch.distributed`` process boundary, at N = 1 and N = 2 processes, and
reports the aggregate fps and the efficiency fps(2) / (2 fps(1)).

- ``--device cpu`` (the JAX tool's layout): gloo over 127.0.0.1, each
  process pinned to one core of this process's affinity set by
  ``taskset``; a missing ``taskset`` or more processes than cores raises.
- the default, the card: NCCL, one process a card; more processes than
  cards raises (N = 2 needs two cards).

Usage: python3 tools_torch/scaling_procs.py [steps] [--device cpu]
"""

from __future__ import annotations

import json
import os
import re
import shutil
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from direct_lidar_odometry_tpu_torch.parallel import sharded  # noqa: E402

WORKER = os.path.join(REPO, "tools_torch", "scaling_procs_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_layout(nprocs: int, device) -> tuple[list[list[str]], dict]:
    """(command prefix of each rank, environment) for ``nprocs`` processes
    on ``device``: on "cuda" one process a card (no prefix); on "cpu"
    ``taskset -c <core>`` over the cores this process may run on, with the
    card hidden. Raises instead of running more processes than cards or
    cores, or unpinned."""
    device = sharded.require_device(device)
    env = dict(os.environ, PYTHONPATH=REPO)
    if device.type == "cuda":
        if nprocs > torch.cuda.device_count():
            raise RuntimeError(f"need {nprocs} cards, have {torch.cuda.device_count()}")
        return [[] for _ in range(nprocs)], env
    cores = sorted(os.sched_getaffinity(0))
    if shutil.which("taskset") is None:
        raise RuntimeError("taskset is not installed: the ranks cannot be pinned to cores")
    if nprocs > len(cores):
        raise RuntimeError(f"need {nprocs} cores, this process may use {len(cores)}")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return [["taskset", "-c", str(cores[r])] for r in range(nprocs)], env


def run_ranks(cmds: list[list[str]], env: dict, timeout: float = 900) -> list[str]:
    """Start every rank's command together and wait for all: their
    standard outputs, in rank order. A rank that fails raises with the end
    of its standard error; every process is gone when this returns."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO) for cmd in cmds]
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} failed rc={p.returncode}:\n{err[-2000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_world(nprocs: int, steps: int, port: int, device="cuda") -> float:
    """Rank 0's aggregate fps of ``nprocs`` workers of ``steps`` timed steps."""
    prefix, env = rank_layout(nprocs, device)
    cmds = [pre + [sys.executable, WORKER, str(rank), str(nprocs), str(port), str(steps),
                   torch.device(device).type] for rank, pre in enumerate(prefix)]
    out = run_ranks(cmds, env)[0]
    m = re.search(r"agg_fps=([0-9.eE+-]+)", out)
    if m is None:
        raise RuntimeError(f"rank 0 printed no fps:\n{out[-2000:]}")
    return float(m.group(1))


def parse_argv(argv: list[str]) -> dict:
    """``[steps] [--device cpu|cuda]``: steps 30 and the card by default."""
    args = list(argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    return dict(steps=int(args[0]) if args else 30, device=device)


def run(steps: int = 30, device="cuda") -> dict:
    """The JAX tool's JSON row: fps at 1 and 2 processes and the efficiency."""
    fps1 = run_world(1, steps, free_port(), device)
    fps2 = run_world(2, steps, free_port(), device)
    kind = torch.device(device).type
    layout = ("taskset-pinned one core per process, gloo" if kind == "cpu"
              else "one card per process, NCCL")
    return {
        "metric": "cross_process_scaling_efficiency",
        "value": fps2 / (2 * fps1),
        "unit": "fraction",
        "fps_1proc_1core": fps1,
        "fps_2proc_2core": fps2,
        "steps": steps,
        "note": f"sharded step, one sequence per process, {layout}, torch.distributed over "
                "127.0.0.1",
    }


def main() -> None:
    print(json.dumps(run(**parse_argv(sys.argv[1:]))))


if __name__ == "__main__":
    main()
