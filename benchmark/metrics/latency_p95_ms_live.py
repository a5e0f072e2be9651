"""latency_p95_ms.live: 95th percentile, over the live window's frames
before the profiled sub-window, of the time from when the scan was due to
when its pose was on the host, as ``latency_p50_ms``'s tail in the traced
run. Spawn frames and the queue behind them set it."""

from benchmark import harness


def read(log, cell):
    if log.driver != "live":
        return None
    return harness.percentile(log.latencies_ms, 95)
