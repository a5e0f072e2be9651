"""latency_p50_ms: median, over every frame due in the live window (in a
traced run, those before the profiled sub-window), of the time from when
the scan was due to when its pose was on the host."""

from benchmark import harness


def read(log, cell):
    if log.driver != "live":
        return None
    return harness.percentile(log.latencies_ms, 50)
