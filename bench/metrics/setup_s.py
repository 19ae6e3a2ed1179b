"""Set-up time: from the process's start to the first timed step (the
kernels' build on a checkout's first run, the weights, the warm-up)."""


def read(run):
    return run.setup_s
