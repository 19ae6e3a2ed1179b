"""Process-parallel execution of independent sweep points — legacy shim.

.. deprecated::
    The fork pool moved into ``repro.api.scheduler`` (``ForkExecutor``
    behind the ``Scheduler`` work queue, which also adds in-process and
    socket-remote executors plus explicit task state).  ``run_tasks`` and
    ``fork_available`` are re-exported here unchanged for existing
    callers; new code should target the scheduler directly.
"""

from __future__ import annotations

from .scheduler import fork_available, run_tasks

__all__ = ["fork_available", "run_tasks"]
