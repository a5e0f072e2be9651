"""device_busy_ms_per_step.fleet: ms in which a device operation ran,
in the profiled fleet sub-window, per step."""


def read(log, cell):
    if log.driver != "fleet" or not log.profile:
        return None
    return log.profile["busy_s"] * 1e3 / log.profile_units
