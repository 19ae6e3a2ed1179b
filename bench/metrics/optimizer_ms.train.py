"""The train step's device time in AdamW's update (``adamw_update``): the
device milliseconds of the program's ``train.optimizer`` spans (timing
events around the call) over the traced steps (2)."""

from bench.harness.spans import device_ms_per


def read(run):
    return device_ms_per(run, "train", "train.optimizer", "train.step")
