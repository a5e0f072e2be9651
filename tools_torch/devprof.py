"""Device profiling helpers shared by ``chip_smoke.py`` and the stage tools.

- :func:`device_events` and :func:`profile_summary` read a finished
  ``torch.profiler`` window: the device operations (kernels, copies, sets),
  their merged busy time and the launches of kernels K1-K4 and K7 by
  their ``__global__`` names, per frame or per step.
- :func:`stage_profile` measures one call of a stage of the per-frame step:
  its synced host ms, its device operations and busy ms, its host reads
  (``utils/sync.py``), the launches of kernels K1-K7 that the wrappers
  counted, each per route (``"cuda"``: the kernel; ``"plain"``: its plain
  PyTorch version), and those of K1-K4 and K7 in its device trace.

Torch, numpy and the port only; the port's modules are imported where they
are used.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

# A profiled stage call runs between two runs of PAD_KERNELS tiny device
# spins. Late in chip_smoke.py (after phases 1-16) torch.profiler dropped
# ~19 device records of most windows, and every record of some, against
# the same calls in a fresh process: a window is kept only if spins
# survive on both sides of the call's records, so that no record of the
# call was lost at either end.
PAD_KERNELS = 64
PROFILE_ATTEMPTS = 3
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel

# kernel -> (wrapper module under direct_lidar_odometry_tpu_torch.ops, its counter)
KERNEL_COUNTERS = {
    "K1": ("cuda_cov", "launches"),
    "K2": ("cuda_nn", "launches"),
    "K3": ("cuda_gicp", "launches"),
    "K4": ("cuda_nn", "mxu_launches"),
    "K5": ("cuda_nn", "exhaustive_launches"),
    "K6": ("cuda_cov", "exhaustive_launches"),
    "K7": ("cuda_lm", "launches"),
}


# each kernel's __global__ functions by name (K2 and K4 are one template
# since K4's redesign, separate kernels before it; K5 and K6 are a pre-pass,
# a scan and a merge since theirs, one kernel before it; K7 is the LM
# trial, not its one-thread re-orthonormalization entry)
KERNEL_NAMES = {
    "K1": r"cov_pruned_kernel",
    "K2": r"nn1_pruned_kernel(<false>)?(\(|$)",
    "K3": r"fused_linearize_kernel",
    "K4": r"nn1_pruned_mxu_kernel|nn1_pruned_kernel<true>",
    "K5": r"nn1_exhaustive_kernel|nn1_merge_kernel|compact_targets_kernel",
    "K6": r"cov_exhaustive_kernel|cov_merge_kernel|compact_targets_kernel",
    "K7": r"lm_trial_kernel",
}
# the kernels whose launches a window counts: one function each, which a
# replayed CUDA graph launches too (the wrappers count only their own)
TRACED_KERNELS = ("K1", "K2", "K3", "K4", "K7")


def device_events(prof) -> list:
    """(name, start ns, end ns) of each device operation (kernel, copy, set)
    of a finished torch.profiler window, read from its kineto results:
    ``prof.events()`` would build the whole host-and-device event tree
    first, tens of seconds for the ~10^5 operations of a profiled
    tensor-op window."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def merged_ns(spans) -> int:
    """Nanoseconds covered by (start, end) intervals, overlaps counted once."""
    merged, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            merged += b - a
            end = b
        elif b > end:
            merged += b - end
            end = b
    return merged


def profile_summary(prof, n: int, wall_ms: float, unit: str = "frame") -> dict:
    """Per ``unit`` (a frame, or a batched step) of a profiled window of
    ``n`` units and ``wall_ms``: the device operations (kernels, copies,
    sets), their summed device time, the time the device was busy (their
    intervals merged, overlaps counted once), each by kind, the eight
    operations that take the most time, the idle share of the window, and
    the launches of K1-K4 and K7 by name (``kernel_launches_per_<unit>``); null
    where the profiler saw no device activity."""
    ops = device_events(prof)
    out = {f"device_ops_per_{unit}": None, f"profiled_wall_ms_per_{unit}": wall_ms / n}
    if ops:
        def kind(name: str) -> str:
            return "memcpy" if name.startswith("Memcpy") else (
                "memset" if name.startswith("Memset") else "kernel")

        summed, busy, count, by_name = {}, {}, {}, {}
        for k in ("kernel", "memcpy", "memset", "all"):
            spans = [(a, b) for name, a, b in ops if k == "all" or kind(name) == k]
            summed[k] = sum(b - a for a, b in spans) / 1e6 / n
            count[k] = len(spans) / n
            busy[k] = merged_ns(spans) / 1e6 / n
        for name, a, b in ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out.update({
            f"device_ops_per_{unit}": count["all"], f"ops_per_{unit}_by_kind": count,
            f"device_event_ms_per_{unit}": summed["all"],
            f"device_busy_ms_per_{unit}": busy["all"],
            f"event_ms_per_{unit}_by_kind": summed, f"busy_ms_per_{unit}_by_kind": busy,
            "idle_share_profiled": 1.0 - busy["all"] / (wall_ms / n),
            f"kernel_launches_per_{unit}": {
                k: sum(1 for name, _, _ in ops if re.search(KERNEL_NAMES[k], name)) / n
                for k in TRACED_KERNELS},
            f"top_ms_per_{unit}": [[name[:80], ms] for name, ms in top],
            # the float64 prefix scan of the voxel filter (ops/voxel.py)
            f"prefix_scan_ms_per_{unit}": sum(ms for name, ms in by_name.items()
                                              if "scan" in name and "double" in name),
        })
    return out


def _counter_modules():
    from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_lm, cuda_nn

    return {"cuda_cov": cuda_cov, "cuda_gicp": cuda_gicp, "cuda_lm": cuda_lm, "cuda_nn": cuda_nn}


def reset_launches() -> None:
    for mod in _counter_modules().values():
        mod.reset_launches()


def read_launches() -> dict:
    """{"K1": {"cuda": n, "plain": n}, ... "K7": ...}: the launch counters."""
    mods = _counter_modules()
    return {k: dict(getattr(mods[m], name)) for k, (m, name) in KERNEL_COUNTERS.items()}


def synchronize(device) -> None:
    """Wait for the device's queue (nothing to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synced_ms(fn, device) -> float:
    """Host ms of one call of ``fn`` through the end of its device work."""
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def stage_profile(fn, n: int = 8, device="cuda") -> dict:
    """One stage call ``fn()`` measured on ``device``, after one warm-up call:

    - ``ms``: host ms of a call through the end of its device work (the
      device synchronized after it), median of ``n`` calls;
    - ``host_reads``: device-to-host reads of one call (``utils/sync.py``,
      reset before it);
    - ``launches``: K1-K7 launches of that call, per route, as the wrappers
      count them (a replayed CUDA graph's are not);
    - ``traced_launches``: K1-K4 and K7 launches of one call in its device trace,
      by name (replayed graphs included); null on the CPU;
    - ``device_ops``, ``busy_ms``: the device operations of one call under
      torch.profiler and the time they kept the device busy (intervals
      merged), the call bracketed by device spins (a window that lost the
      spins at either end is profiled again, PROFILE_ATTEMPTS times at
      most, then this raises); null on the CPU, where there is no device
      to trace;
    - ``pad_records_lost``: the spin records that trace lost (0 when the
      profiler kept every record; null on the CPU).

    ``fn`` must do the same work on every call (a stage that writes a
    state in place is given a state whose writes repeat)."""
    from direct_lidar_odometry_tpu_torch.utils import sync

    device = torch.device(device)
    synced_ms(fn, device)
    sync.reset()
    reset_launches()
    synced_ms(fn, device)
    out = dict(ms=None, device_ops=None, busy_ms=None, host_reads=sync.counts["host_reads"],
               launches=read_launches(), traced_launches=None, pad_records_lost=None)
    out["ms"] = float(np.median([synced_ms(fn, device) for _ in range(n)]))
    if device.type == "cuda":
        ops, out["pad_records_lost"] = _bracketed_ops(fn, device)
        out["device_ops"] = len(ops)
        out["busy_ms"] = merged_ns([(a, b) for _, a, b in ops]) / 1e6
        out["traced_launches"] = {k: sum(1 for name, _, _ in ops
                                         if re.search(KERNEL_NAMES[k], name))
                                  for k in TRACED_KERNELS}
    return out


def _bracketed_ops(fn, device) -> tuple[list, int]:
    """(name, start, end) of the device operations of one call of ``fn``,
    traced between two runs of spins, and the spin records the trace lost;
    a trace that lost the spins at either end is taken again."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(1)

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad()
            fn()
            pad()
            synchronize(device)
        events = sorted(device_events(prof), key=lambda e: e[1])
        if events and SPIN_KERNEL in events[0][0] and SPIN_KERNEL in events[-1][0]:
            ops = [e for e in events if SPIN_KERNEL not in e[0]]
            return ops, 2 * PAD_KERNELS - (len(events) - len(ops))
    raise RuntimeError(f"stage_profile: {PROFILE_ATTEMPTS} profiler traces lost the spins "
                       "around the call, so they may have lost its device records")


PROFILE_HEADER = (f"{'ms':>9s} {'dev ops':>7s} {'busy ms':>8s} {'reads':>5s}  "
                  "K1-K6 launches (+plain; K1-K4 traced on a card)")


def format_profile(p: dict) -> str:
    """One line of :func:`stage_profile`'s columns; a plain-version launch
    shows as "+n" after the kernel's count, which on a card is the traced
    one for K1-K4."""
    ops = "-" if p["device_ops"] is None else str(p["device_ops"])
    busy = "-" if p["busy_ms"] is None else f"{p['busy_ms']:.3f}"
    traced = p.get("traced_launches") or {}
    kernels = " ".join(f"{k}:{traced.get(k, c['cuda'])}" + (f"+{c['plain']}" if c["plain"] else "")
                       for k, c in p["launches"].items())
    return f"{p['ms']:9.3f} {ops:>7s} {busy:>8s} {p['host_reads']:5d}  {kernels}"
