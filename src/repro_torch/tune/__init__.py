"""tune — the paper's approximate-autotuning technique applied to the
port's LM framework on the card.

``lm_study`` (measured): step functions are decomposed into recurring
*kernels* (block forward+backward closures through the port's CUDA kernels,
with concrete input shapes); ``selective.SelectiveTimer`` (a verbatim copy
of ``repro.tune.selective``) applies the paper's confidence-interval
machinery to real wall-clock samples, skipping kernels once predictable.
Front-ended by ``repro_torch.api.AutotuneSession`` (``LMStudy.session``,
``LMStudy.race``).
"""

from .selective import SelectiveTimer, TimerReport
from .lm_study import LMStudy, StepKnobs, lm_config_space

__all__ = ["SelectiveTimer", "TimerReport", "LMStudy", "StepKnobs",
           "lm_config_space"]
