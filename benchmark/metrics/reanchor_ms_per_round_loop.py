"""reanchor_ms_per_round.loop: the re-anchoring, the program's
``refine.reanchor`` spans (host time: its device work drains in the
round's closing read); ms per round run (``refine.rounds``), over the
offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    rounds = got[0].counts.get("refine.rounds", 0) if got else 0
    return program_trace.span_ns(got[0], "refine.reanchor") / 1e6 / rounds if rounds else None
