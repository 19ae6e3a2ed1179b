"""The train step's device time in the backward (``torch.autograd.grad``,
remat's recompute included), once a microbatch: the device milliseconds of
the program's ``train.backward`` spans (timing events around the call)
over the traced steps (2)."""

from bench.harness.spans import device_ms_per


def read(run):
    return device_ms_per(run, "train", "train.backward", "train.step")
