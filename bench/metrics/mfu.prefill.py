"""The prefills' model flops per second of their ``prefill_s`` spans, as a
share of the card's bf16 peak: the whole prefill's utilization, which
bounds what its kernels' rooflines can claim for the time to first
token."""

from bench.cost import MFU_PEAK_FLOPS
from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "serve" \
            or not run.window.get("prefill_s"):
        return None
    flops = sum(W.prefill_model_flops(run.spec, n)
                for n in run.window["prefills"])
    return 100 * flops / run.window["prefill_s"] / MFU_PEAK_FLOPS
