"""train -- optimizer, step function, data pipeline, checkpointing."""

from .optim import AdamWConfig, adamw_init, adamw_update
from .step import TrainConfig, make_train_step, shard_params

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "TrainConfig", "make_train_step", "shard_params"]
