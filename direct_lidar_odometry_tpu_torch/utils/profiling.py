"""Per-frame timing stats and the terminal dashboard.

The reference's observability is a per-scan ANSI dashboard: pose, distance
traveled, computation time (current/average), CPU/RAM
(``odom.cc:1338-1423``). This module reproduces that as a host-side
formatter over the runner's FrameStats, plus rolling timing aggregates.

A numpy copy of the JAX package's ``utils/profiling.py`` (importing any
module of that package runs its ``__init__``, which imports jax);
``tests/test_torch_cli.py`` checks that both format the same dashboard.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TimingStats:
    """Rolling per-frame wall-clock stats (the ``comp_times`` analog,
    reference ``odom.cc:631, 687, 1419``)."""

    times_ms: list = field(default_factory=list)

    def push(self, ms: float) -> None:
        self.times_ms.append(ms)

    @property
    def current(self) -> float:
        return self.times_ms[-1] if self.times_ms else 0.0

    @property
    def average(self) -> float:
        return float(np.mean(self.times_ms)) if self.times_ms else 0.0

    def steady_state(self, skip: int = 5):
        t = np.asarray(self.times_ms[skip:])
        if len(t) == 0:
            return {}
        return {
            "median_ms": float(np.median(t)),
            "p90_ms": float(np.percentile(t, 90)),
            "mean_ms": float(t.mean()),
            "fps": 1000.0 / float(np.median(t)),
        }


def rss_mb() -> float:
    """Resident set size in MB from /proc (reference ``odom.cc:1367-1383``)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return 0.0


class CpuMonitor:
    """Process CPU utilization between dashboard frames (reference
    ``odom.cc:1386-1403``: ``times()`` deltas over wall-clock deltas).

    ``sample()`` returns (cpu_percent_of_one_core, cores_used, n_cores):
    a process burning 1.5 cores reports (150.0, 1.5, N). First call
    returns zeros (no baseline interval yet).
    """

    def __init__(self) -> None:
        self.n_cores = os.cpu_count() or 1
        self._last = None  # (wall, user+sys) seconds

    def sample(self) -> tuple[float, float, int]:
        import time

        t = os.times()
        now = time.monotonic()
        cur = (now, t.user + t.system)
        if self._last is None:
            self._last = cur
            return 0.0, 0.0, self.n_cores
        dw = cur[0] - self._last[0]
        dc = cur[1] - self._last[1]
        self._last = cur
        if dw <= 0:
            return 0.0, 0.0, self.n_cores
        frac = dc / dw
        return frac * 100.0, frac, self.n_cores


def dashboard(frame_idx, position, quat, distance_traveled, timing: TimingStats,
              num_keyframes, health=None, cpu: CpuMonitor | None = None) -> str:
    """One-frame status block (reference ``debug()``, ``odom.cc:1338-1423``).

    ``cpu``: optional persistent :class:`CpuMonitor`; when given, the RAM
    line gains the reference's CPU load / cores-used fields
    (``odom.cc:1386-1403``)."""
    if cpu is not None:
        pct, cores, n = cpu.sample()
        cpu_part = f"   CPU {pct:6.1f} % ({cores:4.2f}/{n} cores)"
    else:
        cpu_part = ""
    ram_line = f"| RAM  {rss_mb():8.1f} MB{cpu_part}"
    lines = [
        "+" + "-" * 60 + "+",
        f"| DLO-TPU  frame {frame_idx:<6}  keyframes {num_keyframes:<5}" + " " * 17 + "|",
        f"| pos  [{position[0]:+8.2f} {position[1]:+8.2f} {position[2]:+8.2f}] m"
        + " " * 17 + "|",
        f"| quat [{quat[0]:+6.3f} {quat[1]:+6.3f} {quat[2]:+6.3f} {quat[3]:+6.3f}]"
        + " " * 19 + "|",
        f"| dist {distance_traveled:8.2f} m   comp {timing.current:7.1f} ms "
        f"(avg {timing.average:7.1f})   |",
        # clamp to the 62-char box so wide values (3-digit core counts,
        # >=100 GB RSS) cannot push past the right border
        ram_line[:61].ljust(61) + "|",
    ]
    if health is not None:
        lines.append(
            f"| s2s it {health.get('s2s_it', 0):<3} nc {health.get('s2s_nc', 0):<6} "
            f"s2m it {health.get('s2m_it', 0):<3} nc {health.get('s2m_nc', 0):<6}"
            + " " * 9 + "|"
        )
    lines.append("+" + "-" * 60 + "+")
    return "\n".join(lines)
