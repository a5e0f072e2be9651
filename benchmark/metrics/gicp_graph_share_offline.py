"""gicp_graph_share.offline: the share of the GICP outer iterations over
the offline window, outside the profiled sub-window, that the program
replayed from a captured CUDA graph. On a CUDA device every ``align``
counts its eagerly issued iterations (``gicp_graph.eager_iters``, 0 on the
graphed path); each of its other iterations (``align_iters.<stage>``) was
replayed. A program without that counter gives None."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, _ = got
    eager = t.counts.get("gicp_graph.eager_iters")
    iters = sum(n for k, n in t.counts.items() if k.startswith("align_iters."))
    if eager is None or not iters:
        return None
    return (iters - eager) / iters
