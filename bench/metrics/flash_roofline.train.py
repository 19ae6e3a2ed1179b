"""The flash kernels' share of their roofline in the traced training steps:
the least time of causal attention's forward and backward a step needs
(``bench/cost``) over the device time of the forward and backward flash
kernels."""

from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "train" or run.trace is None:
        return None
    ks = run.trace.kernel_s
    spent = ks.get("flash_fwd", 0.0) + ks.get("flash_bwd", 0.0)
    if not spent:
        return None
    t = run.traffic
    need = W.train_flash(run.spec, t["batch"], t["seq"], t["grad_accum"])
    return 100 * need.bound_s * run.traced["steps"] / spent
