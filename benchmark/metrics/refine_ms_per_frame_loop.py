"""refine_ms_per_frame.loop: the program's loop-closure rounds, its
``runner.refine`` spans (the round's reads included); ms per frame
stepped, over the offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None or not program_trace.span_ns(got[0], "runner.refine"):
        return None
    t, frames = got
    return program_trace.span_ns(t, "runner.refine") / 1e6 / frames
