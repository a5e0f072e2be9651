"""Reading a finished ``torch.profiler`` window: device operations, busy
time, the longest idle gaps and what the host was doing in them.

The event reading is a frozen copy of the port's ``tools_torch/devprof.py``
(``device_events``), the spans' annotations left out; the rest is the
benchmark's own.
"""

from __future__ import annotations

import time

import torch

# the __global__ names of the port's hand-written kernels K1-K6 and their
# pre-pass and merge kernels (csrc/*.cu)
KERNEL_NAMES = ("cov_pruned_kernel", "nn1_pruned_kernel", "fused_linearize_kernel",
                "nn1_exhaustive_kernel", "nn1_merge_kernel", "cov_exhaustive_kernel",
                "cov_merge_kernel", "compact_targets_kernel")


def kineto_events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def device_events(events) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of each device operation (kernel, copy,
    set); the benchmark's own spans, which the trace also draws on the
    device's timeline, are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == cuda and not e.name().startswith("bench.")]


def host_spans(events) -> list[tuple[str, int, int]]:
    """The benchmark's own spans (``bench.*`` annotations) in the window."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name()[len("bench."):], e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == cpu and e.name().startswith("bench.")]


def merged(spans) -> list[tuple[int, int]]:
    """(start, end) intervals merged where they overlap, in order."""
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def window_summary(prof, window_s: float) -> dict | None:
    """Device operations, busy seconds, seconds by operation name, K1-K6
    seconds, and the idle gaps between device work (each named by the
    innermost benchmark span covering its middle) of a profiled window of
    ``window_s`` host seconds; None when the trace holds no device work."""
    events = kineto_events(prof)
    ops = device_events(events)
    if not ops:
        return None
    by_name: dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    busy = merged([(a, b) for _, a, b in ops])
    spans = host_spans(events)
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (start + end) // 2
        cover = [(b - a, name) for name, a, b in spans if a <= mid <= b]
        gaps.append((min(cover)[1] if cover else "outside_spans", (start - end) / 1e9))
    kernel_s = sum(s for name, s in by_name.items() if any(k in name for k in KERNEL_NAMES))
    return {
        "ops": len(ops),
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": window_s,
        "kernel_s": kernel_s,
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
    }


class Window:
    """A profiled sub-window: ``torch.profiler`` over the host and the
    device between :meth:`start` and :meth:`stop` (nothing on the CPU,
    where there is no device to trace); the recorder's spans meanwhile
    are kept apart."""

    def __init__(self, device, rec):
        self.on = torch.device(device).type == "cuda"
        self.rec = rec
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        self.rec.profiling = True
        self.t0 = time.perf_counter()
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def stop(self) -> dict | None:
        window_s = time.perf_counter() - self.t0
        self.rec.profiling = False
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        out = window_summary(self.prof, window_s)
        self.prof = None
        return out
