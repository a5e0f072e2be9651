"""setup_s: seconds from the start of the run to the opening of the
window: imports, CUDA start-up, the traffic rendered on the card, and the
warm-up of every path the window drives (the kernels' build on a
checkout's first run)."""


def read(log, cell):
    return log.setup_s
