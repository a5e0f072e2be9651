"""loop_edges_per_round.loop: loop edges that passed the GICP gate (the
program's ``refine.edges_accepted``) per round run (``refine.rounds``),
over the offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    rounds = got[0].counts.get("refine.rounds", 0) if got else 0
    return got[0].counts.get("refine.edges_accepted", 0) / rounds if rounds else None
