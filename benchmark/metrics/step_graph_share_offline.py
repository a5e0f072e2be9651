"""step_graph_share.offline: the share of the per-frame step's stretches
outside GICP (front and normals, submap selection and rebuild, keyframe
decision and spawn, the frame's hand-on) over the offline window, outside
the profiled sub-window, that the program replayed from a captured CUDA
graph (``step_graph.replays``), against those replayed or run operation by
operation on the card, warm runs included (``step_graph.eager``). A
program without those counters gives None."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, _ = got
    replays = t.counts.get("step_graph.replays", 0)
    eager = t.counts.get("step_graph.eager", 0)
    if not replays + eager:
        return None
    return replays / (replays + eager)
