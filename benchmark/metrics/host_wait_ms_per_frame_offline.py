"""host_wait_ms_per_frame.offline: ms the main thread spent blocked in the
program's host waits on the device (``utils/sync.py``) over the offline
window outside the profiled sub-window, per frame stepped."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, frames = got
    return sum(ns for (_, _, main), (_, ns) in t.waits.items() if main) / 1e6 / frames
