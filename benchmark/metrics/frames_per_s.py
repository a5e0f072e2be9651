"""frames_per_s: frames whose pose reached the host in the offline
window, over the window's length (from its opening to the last pose read)."""


def read(log, cell):
    if log.driver != "offline" or log.window_s <= 0:
        return None
    return log.frames / log.window_s
