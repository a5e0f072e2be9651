"""gicp_iters_per_frame.offline: ``s2s_iterations + s2m_iterations`` of
every result of the offline window, per frame."""


def read(log, cell):
    if log.driver != "offline" or not log.frames:
        return None
    return log.gicp_iters / log.frames
