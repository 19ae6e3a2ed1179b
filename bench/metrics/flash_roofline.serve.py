"""The flash forward's share of its roofline in the traced serving steps:
the least time of the traced prefills' causal attention (``bench/cost``)
over the device time of the flash forward kernels."""

from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "serve" or run.trace is None \
            or not run.trace.kernel_s.get("flash_fwd") \
            or not run.traced.get("prefills"):
        return None
    need = sum(W.prefill_flash(run.spec, n).bound_s
               for n in run.traced["prefills"])
    return 100 * need / run.trace.kernel_s["flash_fwd"]
