"""Readings that set a cell's limits: the port's compared numbers and the
lower-precision control's, over several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (set-up, the
window, the judged frames), then the check twice: the port's numbers, and
the control's, the reference in the program's place computed in float32
with TF32 products (``reference/judge.py``). One JSON line a seed on
standard output. Runs the cells of ``candidates.json`` too. Needs an
NVIDIA card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import judge  # noqa: E402
from benchmark.run import Context  # noqa: E402


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    """One run of ``cell``: the port's compared numbers and the control's."""
    t0 = time.perf_counter()
    ctx = Context(cell, harness.port_config(cell), seed, seconds, False, device, t0)
    log = harness.driver(cell).run(ctx)
    port, control = [], []
    for drive, cap in log.judged:
        frame = judge.judge_frame(drive, cap)
        port.append(frame)
        control.append(judge.control_frame(drive, cap, frame))
    return {"seed": seed, "frames": log.frames, "judged": len(port),
            "port": judge.summarize(port, log.lost),
            "control": judge.summarize(control, 0),
            "port_frames": [f["pose_gap_m"] for f in port],
            "control_frames": [f["pose_gap_m"] for f in control],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, harness.with_candidates())
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
