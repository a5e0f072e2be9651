"""kernel_ms_per_frame.offline: device time of the port's hand-written
kernels K1-K6 (by their ``__global__`` names, ``devprof.KERNEL_NAMES``) in
the profiled sub-window, per frame."""


def read(log, cell):
    if log.driver != "offline" or not log.profile:
        return None
    return log.profile["kernel_s"] * 1e3 / log.profile_units
