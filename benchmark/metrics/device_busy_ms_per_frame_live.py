"""device_busy_ms_per_frame.live: ms in which a device operation ran, in
the profiled live sub-window, per frame."""


def read(log, cell):
    if log.driver != "live" or not log.profile:
        return None
    return log.profile["busy_s"] * 1e3 / log.profile_units
