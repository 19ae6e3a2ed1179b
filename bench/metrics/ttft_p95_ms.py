"""Time to first token, 95th percentile over every request whose first
token reached the host in the window, from the request's submission."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.window.get("ttft_s"):
        return None
    return 1e3 * float(np.percentile(run.window["ttft_s"], 95))
