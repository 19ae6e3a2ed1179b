"""tune — the paper's approximate-autotuning technique applied to the
port's LM framework on the card.

``lm_study`` (measured): step functions are decomposed into recurring
*kernels* (block forward+backward closures through the port's CUDA kernels,
with concrete input shapes); ``selective.SelectiveTimer`` (a verbatim copy
of ``repro.tune.selective``) applies the paper's confidence-interval
machinery to real wall-clock samples, skipping kernels once predictable.
``dryrun_search`` (production mesh, modeled): configurations are ranked by
the three-term roofline of their dry-run (the step traced on fake tensors
over a fake mesh, against an H100's peaks).  Front-ended by
``repro_torch.api.AutotuneSession`` (``LMStudy.session``, ``LMStudy.race``;
``DryRunBackend`` wraps ``dryrun_search.evaluate_point``).
"""

from .selective import SelectiveTimer, TimerReport
from .lm_study import LMStudy, StepKnobs, lm_config_space
from .dryrun_search import dryrun_search

__all__ = ["SelectiveTimer", "TimerReport", "LMStudy", "StepKnobs",
           "lm_config_space", "dryrun_search"]
