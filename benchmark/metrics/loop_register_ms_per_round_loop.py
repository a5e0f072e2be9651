"""loop_register_ms_per_round.loop: the loop edges' registration (the
candidate list's read, every align, the read of the counts), the
program's ``refine.register`` spans; ms per round run
(``refine.rounds``), over the offline window outside the profiled
sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    rounds = got[0].counts.get("refine.rounds", 0) if got else 0
    return program_trace.span_ns(got[0], "refine.register") / 1e6 / rounds if rounds else None
