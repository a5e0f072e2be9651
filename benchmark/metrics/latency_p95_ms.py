"""latency_p95_ms: 95th percentile, over every frame due in the live
window, of the time from when the scan was due to when its pose was on
the host. Keyframe spawns and the frames queued behind them set it."""

from benchmark import harness


def read(log, cell):
    if log.driver != "live":
        return None
    return harness.percentile(log.latencies_ms, 95)
