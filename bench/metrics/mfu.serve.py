"""The serving window's model flops (the prefills' prompts, the head at
each prompt's last position, each decode token; causal attention) per
second, as a share of the card's bf16 peak."""

from bench.cost import MFU_PEAK_FLOPS
from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "serve" \
            or not run.window.get("decode_s"):
        return None
    flops = sum(W.prefill_model_flops(run.spec, n)
                for n in run.window["prefills"]) \
        + W.decode_model_flops(run.spec, run.window["positions"])
    return 100 * flops / run.window["seconds"] / MFU_PEAK_FLOPS
