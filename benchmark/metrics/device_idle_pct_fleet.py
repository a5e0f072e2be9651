"""device_idle_pct.fleet: the share of the profiled fleet sub-window in
which no device operation ran."""


def read(log, cell):
    if log.driver != "fleet" or not log.profile:
        return None
    return 100.0 * (1.0 - log.profile["busy_s"] / log.profile["window_s"])
