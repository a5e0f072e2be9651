"""dispatch_ms_per_frame.offline: the self time of the program's ``step``
span and its stages (``step.*``), which leaves out their host waits: the
host's own time in the per-frame step, while the card waits for it; ms per
frame stepped, over the offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return sum(program_trace.span_ns(t, n, self_time=True)
               for n in program_trace.step_spans(t)) / 1e6 / frames
