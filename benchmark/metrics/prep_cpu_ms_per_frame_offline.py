"""prep_cpu_ms_per_frame.offline: the self time of the program's
``runner.prepare`` spans (host preprocessing and the wire encoding, on the
worker), which leaves out their blocking copies to the device; ms per
frame prepared, over the offline window outside the profiled sub-window."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, _ = got
    prepared = t.counts.get("frames_prepared", 0)
    if not prepared:
        return None
    return program_trace.span_ns(t, "runner.prepare", self_time=True) / 1e6 / prepared
