"""queue_wait_ms_p95.live: 95th percentile of how late each live frame's
``process_scan`` call started after its scan was due (the feed's own
span: the wait behind a slow earlier frame), over the frames before the
profiled sub-window, which tracing slows."""

from benchmark import harness


def read(log, cell):
    if log.driver != "live":
        return None
    return harness.percentile(log.queue_ms, 95)
