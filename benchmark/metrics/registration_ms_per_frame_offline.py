"""registration_ms_per_frame.offline: the program's GICP stages, the
``step.s2s_coarse``, ``step.s2s``, ``step.s2m`` and ``step.rescue`` spans
(their waits included); ms per frame stepped, over the offline window
outside the profiled sub-window."""

from benchmark import program_trace

STAGES = ("step.s2s_coarse", "step.s2s", "step.s2m", "step.rescue")


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return sum(program_trace.span_ns(t, n) for n in STAGES) / 1e6 / frames
