"""align_iters_per_frame.offline: GICP outer iterations of every align the
program ran (coarse S2S, S2S, S2M and the rescue's two; its
``align_iters.<stage>`` counters) over the offline window outside the
profiled sub-window, per frame stepped."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return sum(n for k, n in t.counts.items() if k.startswith("align_iters.")) / frames
