"""Chaos harness for the scheduler fleet: seeded, reproducible faults.

Two halves, matching the two places failures originate:

- ``FaultPlan`` — a *worker-side* fault schedule, passed to
  ``python -m repro.api.worker --faults '<json>'``.  Deterministic by
  construction (counter-driven, no clock/randomness), so a chaos run is
  replayable: the Nth task request kills or wedges the worker, a reply is
  delayed / dropped / corrupted on schedule.  The ``marker`` file arms
  the lethal faults exactly once across supervisor restarts — the
  restarted worker finds the marker and runs clean, which is what lets a
  "kill one worker mid-task, supervise it back, finish the sweep" script
  converge.

- ``FaultInjector`` — an *executor wrapper* for in-process chaos: wraps
  any ``Executor`` and sabotages results on a seeded ``random.Random``
  schedule (synthesized worker deaths, corrupted replies, straggler
  delays), so ``Scheduler`` retry/skip paths are testable without
  sockets or subprocesses.  The real result of a killed task is computed
  and then discarded — with a deterministic backend the retried attempt
  reproduces it bit-identically, which is exactly the property the chaos
  tests pin.

Every injected fault is journaled (``FaultInjector.log`` and the
executor event stream), so a failing chaos run states what it broke.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .scheduler import Executor


@dataclass
class FaultPlan:
    """Deterministic worker-side fault schedule (all counters 1-based,
    counted over ``run`` requests; ``None`` disables a fault).

    - ``kill_after``:    die (``os._exit(137)``) upon *receiving* the Nth
      task — mid-task from the scheduler's point of view: the request was
      dispatched, no reply will ever come;
    - ``hang_after``:    sleep ``hang_s`` on the Nth task (wedged, not
      dead — exercises the ``RemoteExecutor`` task deadline);
    - ``delay_s``:       straggle every reply by this many seconds;
    - ``drop_after``:    swallow the Nth reply (send nothing);
    - ``corrupt_after``: replace the Nth reply with non-JSON garbage;
    - ``marker``:        filesystem path arming ``kill_after`` /
      ``hang_after`` exactly once: they only fire while the file does not
      exist and create it when they do, so a supervisor-restarted worker
      runs clean.
    """

    kill_after: Optional[int] = None
    hang_after: Optional[int] = None
    delay_s: float = 0.0
    drop_after: Optional[int] = None
    corrupt_after: Optional[int] = None
    hang_s: float = 3600.0
    marker: Optional[str] = None
    _count: int = field(default=0, repr=False)

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(**{k: v for k, v in d.items()
                      if not k.startswith("_")})

    def to_json(self) -> dict:
        d = asdict(self)
        d.pop("_count")
        return d

    def _armed(self) -> bool:
        return self.marker is None or not os.path.exists(self.marker)

    def _fire_marker(self) -> None:
        if self.marker is not None:
            with open(self.marker, "w") as f:
                f.write("fired\n")

    def before_task(self) -> None:
        """Called by the worker when a ``run`` request arrives, before
        executing it.  May never return."""
        self._count += 1
        if self.kill_after is not None and self._count == self.kill_after \
                and self._armed():
            self._fire_marker()
            os._exit(137)           # die mid-task: no reply is ever sent
        if self.hang_after is not None and self._count == self.hang_after \
                and self._armed():
            self._fire_marker()
            time.sleep(self.hang_s)  # wedged: socket stays open, silent

    def transform_reply(self, raw: bytes) -> Optional[bytes]:
        """Sabotage one serialized reply line: returns the bytes to send,
        or ``None`` to drop the reply entirely."""
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.drop_after is not None and self._count == self.drop_after:
            return None
        if self.corrupt_after is not None \
                and self._count == self.corrupt_after:
            return b"\x00garbled{{{not json"
        return raw


class FaultInjector(Executor):
    """Wrap any executor and sabotage its results on a seeded schedule.

    Fates are decided per submission (task index + attempt), so a retried
    task rolls fresh dice — and targeted kills (``kill_tasks``) fire once
    per listed index, which makes "kill exactly task K's first attempt"
    scripts deterministic:

    - ``kill``:    the inner result is discarded and replaced by a
      worker-death error (the scheduler sees a died-mid-task worker);
    - ``corrupt``: the inner result is replaced by a corrupt-reply error;
    - ``delay``:   the result is held for ``delay_s`` (straggler).

    Probabilistic fates draw from ``random.Random(seed)`` with
    probabilities ``kill_prob`` / ``corrupt_prob`` / ``delay_prob``;
    ``max_faults`` caps the total number of injected faults so a chaos
    sweep under retries always terminates.  Injected faults are recorded
    in ``self.log`` and emitted as ``chaos_*`` executor events."""

    def __init__(self, inner: Executor, *, seed: int = 0,
                 kill_tasks: Sequence[int] = (),
                 kill_prob: float = 0.0, corrupt_prob: float = 0.0,
                 delay_prob: float = 0.0, delay_s: float = 0.02,
                 max_faults: Optional[int] = None):
        self.inner = inner
        self.rng = random.Random(seed)
        self.kill_tasks = set(kill_tasks)
        self.kill_prob = kill_prob
        self.corrupt_prob = corrupt_prob
        self.delay_prob = delay_prob
        self.delay_s = delay_s
        self.max_faults = max_faults
        self.log: List[dict] = []
        self._killed: Set[int] = set()
        self._fates: Dict[int, Optional[str]] = {}

    # capacity/can_grow mirror the wrapped executor
    @property
    def capacity(self) -> int:
        return self.inner.capacity

    @property
    def can_grow(self) -> bool:
        return self.inner.can_grow

    def _budget_left(self) -> bool:
        return self.max_faults is None or len(self.log) < self.max_faults

    def start(self, runner) -> None:
        self.inner.start(runner)

    def submit(self, index: int, payload: dict) -> None:
        fate = None
        if index in self.kill_tasks and index not in self._killed:
            fate = "kill"
            self._killed.add(index)
        elif self._budget_left():
            r = self.rng.random()
            if r < self.kill_prob:
                fate = "kill"
            elif r < self.kill_prob + self.corrupt_prob:
                fate = "corrupt"
            elif r < self.kill_prob + self.corrupt_prob + self.delay_prob:
                fate = "delay"
        if fate is not None:
            self.log.append({"task": index, "fate": fate})
        self._fates[index] = fate
        self.inner.submit(index, payload)

    def poll(self) -> List[Tuple[int, dict]]:
        out: List[Tuple[int, dict]] = []
        for idx, res in self.inner.poll():
            fate = self._fates.pop(idx, None)
            if fate == "kill" and "ok" in res:
                self._emit(event="chaos_kill", task=idx)
                res = {"err": f"[chaos] worker killed mid-task {idx} "
                              f"(result discarded by FaultInjector)",
                       "worker": "chaos"}
            elif fate == "corrupt" and "ok" in res:
                self._emit(event="chaos_corrupt", task=idx)
                res = {"err": f"[chaos] corrupted reply for task {idx}",
                       "worker": "chaos"}
            elif fate == "delay":
                self._emit(event="chaos_delay", task=idx,
                           delay_s=self.delay_s)
                time.sleep(self.delay_s)
            out.append((idx, res))
        return out

    def drain_events(self) -> List[dict]:
        return self.inner.drain_events() + super().drain_events()

    def close(self) -> None:
        self.inner.close()
