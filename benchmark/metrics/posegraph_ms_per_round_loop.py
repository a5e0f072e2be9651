"""posegraph_ms_per_round.loop: the pose-graph solve (building the graph,
the Gauss-Newton iterations and their dense solves), the program's
``refine.solve`` spans; ms per round run (``refine.rounds``), over the
offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    rounds = got[0].counts.get("refine.rounds", 0) if got else 0
    return program_trace.span_ns(got[0], "refine.solve") / 1e6 / rounds if rounds else None
