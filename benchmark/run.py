"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; their files, the cell's limits and each metric's reader are
found by name (``benchmark/harness.py``). One process: set-up (rendering
the traffic on the card, warming every path it uses), the measured window,
then the check against the plain reference (``benchmark/reference/``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and ``checks``: each compared number with
its limit, also printed as the last lines of standard error.

Needs an NVIDIA card: without one (or with fewer than the cell asks for)
it prints no result and exits with code 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import judge  # noqa: E402


class Context:
    """What a driver is given: the cell, the port's config, the run's
    seed, window length, trace flag and device."""

    def __init__(self, cell, cfg, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.cell, self.cfg, self.seed, self.seconds, self.trace = cell, cfg, seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.window_opened = None

    def open_window(self) -> float:
        harness.synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.window_opened = time.perf_counter()
        return self.window_opened


def metric_values(cell, log, names) -> dict:
    out = {}
    for m in names:
        value = harness.reader(m["name"]).read(log, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(profile: dict | None) -> dict | None:
    if not profile:
        return None
    return {"device_ops": [[n[:120], s] for n, s in profile["top_ops"]],
            "idle_gaps": [[n, s] for n, s in profile["idle_gaps"]]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run of ``cell``: the window, then the check. Returns the result
    line as a dict (the caller prints it)."""
    t_start = T_START if t_start is None else t_start
    cfg = harness.port_config(cell)
    ctx = Context(cell, cfg, seed, seconds, trace, device, t_start)
    log = harness.driver(cell).run(ctx)
    log.setup_s = ctx.window_opened - t_start
    dev = ctx.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        prof = log.profile or {}
        info["busy_s"] = prof.get("busy_s")
        info["window_s"] = prof.get("window_s")

    frames = [judge.judge_frame(drive, cap) for drive, cap in log.judged]
    numbers = judge.summarize(frames, log.lost)
    # the numbers compared in this cell are those its limits file names
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = bool(frames) and all(c["value"] <= c["limit"] for c in checks.values())
    names = cell.per_layer if trace else cell.end_to_end
    result = {"correct": correct, "attempted": log.attempted, "failed": log.lost,
              "metrics": metric_values(cell, log, names), "device": info}
    if trace and breakdown(log.profile):
        result["breakdown"] = breakdown(log.profile)
    # what set-up spent its time on: the traffic rendered, the warm-up
    result["setup_parts_s"] = {k: sum(b - a for a, b, _ in log.rec.spans.get(k, []))
                               for k in ("render", "warm")}
    result["judged_frames"] = len(frames)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} NVIDIA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
