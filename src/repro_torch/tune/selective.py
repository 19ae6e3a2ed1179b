"""Selective wall-clock kernel timing — the paper's §III.A machinery over
real jitted-closure executions (no virtual machine).

This is the measurement substrate of ``repro.api.WallClockBackend``; the
supported way to drive it is ``repro.api.AutotuneSession`` (see the
top-level README), which owns the per-configuration protocol, sweeps and
checkpointing.  Direct ``SelectiveTimer`` use remains for single-kernel
call sites (e.g. the serving engine's step timer).

All kernels here are computation kernels (one process, XLA dispatch), so
the propagation policies collapse to how execution *counts* are used:

- ``conditional``: plain CI, one execution per kernel per iteration;
- ``local``/``online``: CI shrunk by sqrt(freq) of the kernel's per-step
  count (identical single-process; kept as separate names for reporting
  parity with the paper);
- ``eager``: a kernel switches off permanently (across configurations)
  the first time its CI meets the tolerance — the cross-configuration
  model reuse of the paper's Capital study.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.policies import Policy
from repro_torch.core.signatures import Signature
from repro_torch.core.stats import KernelStats


@dataclass
class TimerReport:
    predicted_time: float
    measured_time: float
    executed: int
    skipped: int


class SelectiveTimer:
    """Owns kernel statistics across tuning iterations (one per policy).

    ``prior_lookup`` (cross-study transfer, ``repro.api.transfer``) maps a
    ``Signature`` to a transferred ``KernelStats`` or ``None``; it is
    consulted lazily the first time each kernel appears — and again after
    every ``reset_models`` — so warm-started kernels carry a tight CI
    before their first timed execution, and an eager session switches an
    already-confident kernel off outright.
    """

    def __init__(self, policy: Policy, clock: Callable[[], float] = None,
                 prior_lookup: Optional[Callable[[Signature],
                                                 Optional[KernelStats]]]
                 = None):
        self.policy = policy
        self.kbar: Dict[Signature, KernelStats] = {}
        self.global_off: set = set()
        self.clock = clock or time.perf_counter
        self.prior_lookup = prior_lookup
        self._iter_executed: set = set()
        self._pred = 0.0
        self._meas = 0.0
        self._nexec = 0
        self._nskip = 0

    def reset_models(self):
        self.kbar.clear()
        self.global_off.clear()

    def _stats(self, sig: Signature) -> KernelStats:
        st = self.kbar.get(sig)
        if st is None:
            st = self.prior_lookup(sig) if self.prior_lookup else None
            if st is None:
                st = KernelStats()
            elif self.policy.persistent_models and st.n > 0 \
                    and st.is_predictable(self.policy.tolerance, 1,
                                          self.policy.min_samples):
                self.global_off.add(sig)
            self.kbar[sig] = st
        return st

    def begin_iteration(self):
        self._iter_executed = set()
        self._pred = self._meas = 0.0
        self._nexec = self._nskip = 0

    def _should_execute(self, sig: Signature, freq: int) -> bool:
        if sig in self.global_off:
            return False
        if self.policy.once_per_iteration and sig not in self._iter_executed:
            return True
        st = self.kbar.get(sig)
        if st is None:
            return True
        f = freq if self.policy.uses_counts else 1
        return not st.is_predictable(self.policy.tolerance, f,
                                     self.policy.min_samples)

    def time_kernel(self, sig: Signature, thunk: Callable[[], None],
                    freq: int = 1, *, force: bool = False) -> float:
        """Run (or skip) one kernel occurrence; returns the time charged to
        the configuration's predicted cost.  ``freq`` is the kernel's
        occurrence count along the step (the paper's alpha).

        ``force=True`` executes and measures even a confident (or globally
        switched-off) kernel — shadow mode: the serving daemon's drift
        detector periodically forces a real sample so live evidence keeps
        flowing after the skip regime is reached."""
        st = self._stats(sig)
        if force or self._should_execute(sig, freq):
            t0 = self.clock()
            thunk()
            t = self.clock() - t0
            st.update(t)
            self._iter_executed.add(sig)
            self._nexec += 1
            self._meas += t
            charged = t
            if self.policy.persistent_models and st.is_predictable(
                    self.policy.tolerance, 1, self.policy.min_samples):
                self.global_off.add(sig)
        else:
            charged = st.mean
            self._nskip += 1
        self._pred += charged
        return charged

    def report(self) -> TimerReport:
        return TimerReport(self._pred, self._meas, self._nexec, self._nskip)
