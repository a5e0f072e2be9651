"""host_reads_per_frame.live: device-to-host reads counted by the port's
``utils/sync.py`` over the live window, per frame."""


def read(log, cell):
    if log.driver != "live" or not log.frames:
        return None
    return log.host_reads / log.frames
