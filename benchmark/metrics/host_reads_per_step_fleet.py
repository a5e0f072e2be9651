"""host_reads_per_step.fleet: device-to-host reads counted by the port's
``utils/sync.py`` over the fleet window, per lock-step step."""


def read(log, cell):
    if log.driver != "fleet" or not log.steps:
        return None
    return log.host_reads / log.steps
