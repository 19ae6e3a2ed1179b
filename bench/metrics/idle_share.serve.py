"""The device's idle share in the traced serving steps: 1 - (the union of
its operations' intervals) / the traced window."""


def read(run):
    if run.device != "cuda" or run.kind != "serve" or run.trace is None \
            or not run.trace.busy_s:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
