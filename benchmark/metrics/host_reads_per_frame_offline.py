"""host_reads_per_frame.offline: device-to-host reads counted by the
port's ``utils/sync.py`` over the offline window, per frame."""


def read(log, cell):
    if log.driver != "offline" or not log.frames:
        return None
    return log.host_reads / log.frames
