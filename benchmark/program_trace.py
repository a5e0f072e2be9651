"""The port's own spans, waits and counters (``utils/sync.py`` of the
program) over the offline window, for the ``metrics/`` readers that read
them: each a number per frame the program stepped, outside the profiled
sub-window (the program keeps what ends while a profiler runs apart).
Nothing here writes to the program; a program without the aggregates
(``sync.totals``) gives None, and its readers report nothing."""

from __future__ import annotations


def offline_window(log):
    """(the program's aggregates outside profiling, the frames it stepped
    there), or None when the run is not the offline driver's or the
    program keeps no such aggregates or stepped no frame."""
    if log.driver != "offline":
        return None
    from direct_lidar_odometry_tpu_torch.utils import sync

    totals = getattr(sync, "totals", None)
    if totals is None:
        return None
    t = totals()
    frames = t.counts.get("frames", 0)
    return (t, frames) if frames else None


def span_ns(t, name: str, self_time: bool = False) -> int:
    """The total (or the self) ns of the spans named ``name``."""
    agg = t.spans.get(name)
    return 0 if agg is None else agg[2 if self_time else 1]


def step_spans(t) -> list[str]:
    """``step`` and its stages (``step.*``)."""
    return [n for n in t.spans if n == "step" or n.startswith("step.")]
