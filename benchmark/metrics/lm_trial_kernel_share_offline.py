"""lm_trial_kernel_share.offline: the share of the GICP Levenberg-Marquardt
trials over the offline window, outside the profiled sub-window, that the
program ran as its trial kernel, eagerly launched or replayed in a CUDA
graph (``gicp_trial.kernel``), against every trial it counted
(``lm_steps.<stage>``). A program without that counter gives None."""

from benchmark import program_trace


def read(log, cell):
    got = program_trace.offline_window(log)
    if got is None:
        return None
    t, _ = got
    kernel = t.counts.get("gicp_trial.kernel")
    steps = sum(n for k, n in t.counts.items() if k.startswith("lm_steps."))
    if kernel is None or not steps:
        return None
    return kernel / steps
