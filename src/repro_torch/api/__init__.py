"""repro_torch.api — the autotuning front-end of the port.

Session-based access to the paper's confidence-interval-gated selective
execution, measured by wall clock on the card::

    from repro_torch.tune import LMStudy

    result = LMStudy("smollm-135m").session(policy="conditional",
                                            tolerance=0.25).run()
    print(result.speedup, result.chosen.name)

Verbatim copies of ``repro.api``'s NumPy-only modules (``space``,
``result``, ``serialize``, ``search``, ``scheduler``, ``transfer``,
``session``) and of the wall-clock subset of ``backends``; only
``repro.`` imports are rewritten (``tests/test_torch_copies.py``).  Not
ported: ``SimBackend``, ``DryRunBackend`` and the daemon, fault and worker
modules.
"""

from .backends import (Backend, BackendRun, Measurement, WallClockBackend,
                       WallClockRun)
from .result import ConfigRecord, StudyResult
from .scheduler import (Executor, ForkExecutor, InProcessExecutor,
                        RemoteExecutor, Scheduler, SchedulerError, Task,
                        fork_available)
from .search import (SEARCHES, exhaustive, measure_config, model_guided,
                     racing)
from .serialize import dumps_canonical, from_jsonable, to_jsonable
from .session import AutotuneSession, run_payload
from .space import RESET_POLICY, ConfigPoint, SearchSpace
from .transfer import CopulaModel, StatisticsBank

__all__ = [
    "AutotuneSession", "Backend", "BackendRun", "ConfigPoint",
    "ConfigRecord", "CopulaModel", "Executor", "ForkExecutor",
    "InProcessExecutor", "Measurement", "RESET_POLICY", "RemoteExecutor",
    "SEARCHES", "Scheduler", "SchedulerError", "SearchSpace",
    "StatisticsBank", "StudyResult", "Task", "WallClockBackend",
    "WallClockRun", "dumps_canonical", "exhaustive", "fork_available",
    "from_jsonable", "measure_config", "model_guided", "racing",
    "run_payload", "to_jsonable",
]
