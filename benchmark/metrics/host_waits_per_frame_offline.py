"""host_waits_per_frame.offline: the program's host waits on the device
(reads, event waits, blocking copies, index reads; ``utils/sync.py``) over
the offline window outside the profiled sub-window, on every thread, per
frame stepped."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return sum(n for n, _ in t.waits.values()) / frames
