"""The training window's model flops (6 a parameter a token, plus causal
attention's three passes) per second, as a share of the card's bf16 peak."""

from bench.cost import MFU_PEAK_FLOPS
from bench.cost import model as W


def read(run):
    if run.device != "cuda" or run.kind != "train" \
            or not run.window.get("steps"):
        return None
    t = run.traffic
    flops = W.train_model_flops(run.spec, t["batch"], t["seq"]) \
        * run.window["steps"]
    return 100 * flops / run.window["seconds"] / MFU_PEAK_FLOPS
