"""The MoE FFN's device time in a decode step: the device milliseconds of
the program's ``model.moe_ffn`` spans inside ``engine.decode`` spans (one
a layer, timing events around the call), over the traced stretch's decode
steps (about 13 in the closed cell)."""

from bench.harness.spans import device_ms_per


def read(run):
    return device_ms_per(run, "serve", "model.moe_ffn", "engine.decode",
                         within="engine.decode")
