"""runner_ms_per_frame.offline: the self time of the program's
``runner.chunk`` spans, outside ``step`` and outside host waits (the IMU
priors, the host hulls, the stacking of results); ms per frame stepped,
over the offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return program_trace.span_ns(t, "runner.chunk", self_time=True) / 1e6 / frames
