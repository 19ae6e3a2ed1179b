"""train -- optimizer, step function, data pipeline, checkpointing (the
reference's ``shard_params`` waits for the multi-GPU port)."""

from .optim import AdamWConfig, adamw_init, adamw_update
from .step import TrainConfig, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "TrainConfig", "make_train_step"]
