"""repro_torch.api — the autotuning front-end of the port.

Session-based access to the paper's confidence-interval-gated selective
execution over pluggable measurement backends: wall clock on the card, or
the simulator on the host::

    from repro_torch.tune import LMStudy

    result = LMStudy("smollm-135m").session(policy="conditional",
                                            tolerance=0.25).run()
    print(result.speedup, result.chosen.name)

    from repro_torch.api import AutotuneSession, SimBackend
    from repro_torch.linalg.studies import search_space

    result = AutotuneSession(search_space("slate-cholesky"),
                             backend=SimBackend(), policy="online",
                             tolerance=0.25).run()

Verbatim copies of ``repro.api``'s NumPy-only modules (``space``,
``result``, ``serialize``, ``search``, ``scheduler``, ``transfer``,
``session``, ``daemon``, ``faults``, ``parallel``, ``worker``,
``supervisor``) and of ``backends``' classes; only ``repro.`` imports
are rewritten, and in ``supervisor`` the worker's module path, so that a
``WorkerPool`` spawns ``python -m repro_torch.api.worker``
(``tests/test_torch_copies.py``).  The always-on tuning daemon
(``daemon``) is bound to the LM studies by ``repro_torch.serve.tuner``;
``DryRunBackend`` scores ``tune.dryrun_search`` points by the port's
dry-run.
"""

from .backends import (Backend, BackendRun, DryRunBackend, Measurement,
                       SimBackend, WallClockBackend, WallClockRun,
                       dryrun_space)
from .daemon import (BackgroundTuner, DaemonCheckpoint, DaemonConfig,
                     DriftDetector, FleetStore, TuningDaemon)
from .faults import FaultInjector, FaultPlan
from .result import ConfigRecord, StudyResult
from .scheduler import (Executor, ForkExecutor, InProcessExecutor,
                        RemoteExecutor, Scheduler, SchedulerError, Task,
                        fork_available)
from .search import (SEARCHES, exhaustive, measure_config, model_guided,
                     racing)
from .serialize import dumps_canonical, from_jsonable, to_jsonable
from .session import AutotuneSession, run_payload
from .space import RESET_POLICY, ConfigPoint, SearchSpace
from .supervisor import WorkerPool, WorkerSpec
from .transfer import CopulaModel, StatisticsBank

__all__ = [
    "AutotuneSession", "Backend", "BackendRun", "BackgroundTuner",
    "ConfigPoint", "ConfigRecord", "CopulaModel", "DaemonCheckpoint",
    "DaemonConfig", "DriftDetector", "DryRunBackend", "Executor",
    "FaultInjector",
    "FaultPlan", "FleetStore", "ForkExecutor", "InProcessExecutor",
    "Measurement", "RESET_POLICY", "RemoteExecutor", "SEARCHES",
    "Scheduler", "SchedulerError", "SearchSpace", "SimBackend",
    "StatisticsBank", "StudyResult", "Task", "TuningDaemon",
    "WallClockBackend", "WallClockRun", "WorkerPool", "WorkerSpec",
    "dryrun_space", "dumps_canonical", "exhaustive",
    "fork_available", "from_jsonable", "measure_config", "model_guided",
    "racing", "run_payload", "to_jsonable",
]
