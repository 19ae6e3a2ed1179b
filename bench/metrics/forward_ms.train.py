"""The train step's device time in the loss's forward (``model.loss``), once
a microbatch: the device milliseconds of the program's ``train.forward``
spans (timing events around the call) over the traced steps (2)."""

from bench.harness.spans import device_ms_per


def read(run):
    return device_ms_per(run, "train", "train.forward", "train.step")
