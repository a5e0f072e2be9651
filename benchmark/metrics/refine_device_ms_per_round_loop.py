"""refine_device_ms_per_round.loop: the device's busy time inside the
program's ``runner.refine`` spans in the profiled sub-window (merged
device operations clipped to each span, ``drivers/loop.py``), per round
there."""


def read(log, cell):
    prof = log.profile or {}
    rounds = prof.get("refine_rounds")
    return 1e3 * prof["refine_device_s"] / rounds if rounds else None
