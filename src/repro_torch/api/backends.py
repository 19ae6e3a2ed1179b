"""Measurement backends for the session front-end (the subset of
``repro.api.backends`` that the wall-clock tuning loop needs).

- ``WallClockBackend`` real timing of kernel sequences (closures running a
                       forward+backward through the port's CUDA kernels)
                       via ``SelectiveTimer``: the paper's technique on the
                       LM framework itself.

``Measurement``, ``BackendRun``, ``Backend``, ``WallClockBackend`` and
``WallClockRun`` are verbatim copies of the originals (only ``repro.``
imports rewritten; ``tests/test_torch_copies.py`` holds them to it).
``SimBackend`` and ``DryRunBackend`` are not ported: they stand on the
simulator and on HLO lowering.

The run protocol (the paper's per-configuration measurement sequence,
section VI.A), which the search drivers orchestrate:

- ``run_reference``  full execution, models untouched (error reference);
- ``run_trial``      one selective execution;
- ``reset_models``   forget kernel statistics (between configurations).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.policies import Policy

from .space import ConfigPoint, SearchSpace


@dataclass
class Measurement:
    """One execution's outcome, backend-agnostic.

    ``time`` is what the run actually took (the full-execution reference
    time when forced); ``cost`` is the wall time charged to the autotuning
    budget; ``predicted`` the selective estimate of the configuration's
    time; ``comp`` the critical-path computation component (0 when the
    backend has no path decomposition).
    """

    predicted: float
    time: float
    cost: float
    comp: float = 0.0
    executed: int = 0
    skipped: int = 0
    extra: dict = field(default_factory=dict)


class BackendRun:
    """Per-(study, policy) execution context.  Subclasses own all mutable
    measurement state; the base class only fixes the interface."""

    def carry_state(self) -> Optional[dict]:
        """JSON-able state that survives a model reset and must carry into
        the next configuration for a resumed study to be bit-identical to
        an uninterrupted one (the sim backend's RNG stream).  ``None``
        when the backend has no such state."""
        return None

    def restore_carry(self, state: Optional[dict]) -> None:
        if state is not None:
            raise NotImplementedError(
                f"{type(self).__name__} cannot restore carry state")

    def export_stats(self) -> Optional[dict]:
        """Bank payload (``StatisticsBank.to_json`` shape) of every kernel
        statistic this run accumulated, pooled across ranks and across
        model resets.  ``None`` when the backend keeps no statistics."""
        return None

    def reset_models(self) -> None:
        raise NotImplementedError

    def run_reference(self, point: ConfigPoint) -> Measurement:
        raise NotImplementedError

    def run_offline(self, point: ConfigPoint) -> Measurement:
        raise NotImplementedError(
            "this backend has no offline pass; the 'apriori' policy "
            "requires SimBackend")

    def run_trial(self, point: ConfigPoint) -> Measurement:
        raise NotImplementedError

    # -- model-guided search hooks (repro.api.search.model_guided) -----------

    def kernel_profile(self, point: ConfigPoint) -> Optional[Dict]:
        """Structural kernel-occurrence profile of one configuration:
        ``{structural_key: per-rank occurrence counts}``, obtained WITHOUT
        consuming measurement state (the sim backend uses the RNG-free
        recording pass), so profiling every candidate leaves the run
        bit-identical to one that never profiled.  ``None`` when the
        backend cannot see kernel structure — the model-guided driver then
        falls back to uniform candidate sampling."""
        return None

    def cache_info(self) -> Optional[dict]:
        """Event-program cache observability for ``StudyResult.extra``:
        per-point structural fingerprints plus hit/miss/recording counters
        (see ``repro.simmpi.program``).  ``None`` when the backend has no
        program cache — the common case for non-sim backends and for sim
        runs opened without one."""
        return None

    def cost_lower_bound(self, point: ConfigPoint) -> Optional[float]:
        """Analytic lower bound on the configuration's step time (roofline:
        no schedule can beat its compute at peak flops / memory
        bandwidth), used to prune provably-dominated candidates before any
        dispatch.  ``None`` when no machine model is available — nothing
        is pruned."""
        return None


class Backend:
    """Backend factory protocol: stateless description + ``open``."""

    name: str = "?"
    #: False for backends whose runs touch JAX/XLA (forked children can
    #: deadlock on runtime locks) or measure real wall clock (forked
    #: siblings contend for cores and corrupt timings) — sweeps over such
    #: backends are forced serial regardless of ``workers``.
    parallel_safe: bool = True

    def fingerprint(self) -> dict:
        """JSON-able identity of this backend's measurement configuration,
        part of the session checkpoint key: results journaled under one
        configuration must not be replayed as another's."""
        return {"name": self.name}

    def open(self, space: SearchSpace, policy: Policy, *,
             seed: int = 0, allocation: int = 0,
             prior=None) -> BackendRun:
        """Build the per-(study, policy) execution context.  ``prior`` is
        an optional ``repro.api.transfer.StatisticsBank`` (already
        discounted by the session); backends without statistical state
        (dry run) ignore it."""
        raise NotImplementedError


class WallClockBackend(Backend):
    """Real wall-clock timing of recurring kernels via ``SelectiveTimer``.

    ``kernels_of(point) -> [(Signature, thunk, freq)]`` resolves a point to
    its step's kernel occurrence list (thunks pre-compiled, so timing sees
    only execution); ``freq`` is the kernel's per-step occurrence count
    (the paper's alpha).  ``LMStudy.kernels_of`` is the canonical provider.
    """

    name = "wallclock"
    parallel_safe = False     # real timing + jitted closures: serial only

    def __init__(self, kernels_of: Callable[[ConfigPoint], Sequence[Tuple]],
                 *, clock: Optional[Callable[[], float]] = None):
        self.kernels_of = kernels_of
        self.clock = clock

    def fingerprint(self) -> dict:
        return {"name": self.name,
                "clock": "custom" if self.clock is not None else "default"}

    def open(self, space: SearchSpace, policy: Policy, *,
             seed: int = 0, allocation: int = 0,
             prior=None) -> "WallClockRun":
        return WallClockRun(self.kernels_of, policy, clock=self.clock,
                            prior=prior)


class WallClockRun(BackendRun):
    def __init__(self, kernels_of, policy: Policy, *, clock=None,
                 prior=None):
        from repro_torch.api.transfer import Harvest
        from repro_torch.tune.selective import SelectiveTimer
        self.policy = policy
        # wall-clock studies are single-process compute-kernel streams:
        # structural keys carry no communicator geometry, so the bank
        # resolves (and harvests) against a world of 1
        self.timer = SelectiveTimer(
            policy, clock=clock,
            prior_lookup=prior.resolver(1) if prior else None)
        self.kernels_of = kernels_of
        self._harvest = Harvest(1, prior)

    def export_stats(self) -> dict:
        return self._harvest.payload(self.timer.kbar)

    def reset_models(self) -> None:
        self._harvest.add(self.timer.kbar)
        self.timer.reset_models()

    def run_reference(self, point: ConfigPoint) -> Measurement:
        clock = self.timer.clock
        total = 0.0
        n = 0
        for sig, thunk, freq in self.kernels_of(point):
            t0 = clock()
            thunk()
            total += clock() - t0
            n += 1
        # the reference is not charged to the tuning budget (the driver
        # accounts full_cost = full_time x trials, as the paper does)
        return Measurement(predicted=total, time=total, cost=0.0,
                           executed=n)

    def run_trial(self, point: ConfigPoint) -> Measurement:
        timer = self.timer
        timer.begin_iteration()
        for sig, thunk, freq in self.kernels_of(point):
            timer.time_kernel(sig, thunk, freq)
        rep = timer.report()
        return Measurement(predicted=rep.predicted_time,
                           time=rep.measured_time, cost=rep.measured_time,
                           executed=rep.executed, skipped=rep.skipped)
