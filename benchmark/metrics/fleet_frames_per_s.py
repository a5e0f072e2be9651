"""fleet_frames_per_s: lane-frames whose poses reached the host in the
fleet window, over the window's length."""


def read(log, cell):
    if log.driver != "fleet" or log.window_s <= 0:
        return None
    return log.frames / log.window_s
