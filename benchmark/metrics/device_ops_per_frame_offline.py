"""device_ops_per_frame.offline: device operations (kernels, copies,
sets) in the profiled sub-window of the offline window, per frame."""


def read(log, cell):
    if log.driver != "offline" or not log.profile:
        return None
    return log.profile["ops"] / log.profile_units
