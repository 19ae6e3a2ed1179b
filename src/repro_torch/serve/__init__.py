"""serve — the slot-batched serving engine and the always-on tuning
daemon binding (``repro_torch.serve.tuner``)."""

from .engine import Engine, ServeConfig, bucket_length
from .tuner import (LMShapeProvider, ServingTuner, VirtualClock,
                    run_daemon_demo, shape_key)

__all__ = ["Engine", "LMShapeProvider", "ServeConfig", "ServingTuner",
           "VirtualClock", "bucket_length", "run_daemon_demo", "shape_key"]
