"""refine_rounds_per_frame.loop: loop-closure rounds the program ran (its
``refine.rounds`` counter) per frame stepped, over the offline window
outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None or not got[0].counts.get("refine.rounds"):
        return None
    t, frames = got
    return t.counts["refine.rounds"] / frames
