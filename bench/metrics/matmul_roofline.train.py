"""The matmul kernel's share of its roofline in the traced training steps:
the least time of the products a step needs (forward, dA and dB; nothing
recomputed; ``bench/cost``) over the device time of the program's matmul
kernels."""

from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "train" or run.trace is None \
            or not run.trace.kernel_s.get("matmul"):
        return None
    t = run.traffic
    need = W.train_matmul(run.spec, t["batch"], t["seq"], t["grad_accum"])
    return (100 * need.bound_s * run.traced["steps"]
            / run.trace.kernel_s["matmul"])
