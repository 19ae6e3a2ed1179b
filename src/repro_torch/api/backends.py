"""Measurement backends for the session front-end (the subset of
``repro.api.backends`` that the port runs).

- ``SimBackend``       virtual-machine studies: the simmpi ``Runtime``
                       driving ``Critter`` interception over a schedule
                       program (the paper's evaluation vehicle; NumPy only);
- ``WallClockBackend`` real timing of kernel sequences (closures running a
                       forward+backward through the port's CUDA kernels)
                       via ``SelectiveTimer``: the paper's technique on the
                       LM framework itself;
- ``DryRunBackend``    trace-and-score: ranks configurations by the
                       dominant roofline term of the step traced on fake
                       tensors over a fake production mesh
                       (``tune.dryrun_search``), against an H100's peaks.

``Measurement``, ``BackendRun``, ``Backend``, ``SimBackend``, ``SimRun``,
``WallClockBackend``, ``WallClockRun``, ``DryRunBackend``, ``DryRunRun``
and ``dryrun_space`` are verbatim copies of the originals (only ``repro.``
imports rewritten; ``tests/test_torch_copies.py`` holds them to it), so
their comments speak of the reference's lowering; the port traces.

The run protocol (the paper's per-configuration measurement sequence,
section VI.A), which the search drivers orchestrate:

- ``run_reference``  full execution, models untouched (error reference);
- ``run_offline``    full execution that feeds the models (the a-priori
                     policy's charged offline pass);
- ``run_trial``      one selective execution;
- ``reset_models``   forget kernel statistics (between configurations).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

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


# --------------------------------------------------------------------- sim

class SimBackend(Backend):
    """Virtual-machine measurement: simmpi ``Runtime`` + ``Critter``.

    Point payloads are program factories ``make_program(world) ->
    program_factory(rank, world)`` (the ``Configuration.make_program``
    convention of the linalg studies).
    """

    name = "sim"

    def __init__(self, *, machine=None, timer: Optional[Callable] = None,
                 cost_model=None, overhead: float = 1e-6,
                 program_cache=None):
        self.machine = machine
        self.timer = timer
        self.cost_model = cost_model
        self.overhead = overhead
        # cross-run event-program cache (repro.simmpi.program.ProgramCache):
        # pass an instance to share one across backends, a directory path
        # for the crash-atomic on-disk store, or "mem" for a process-local
        # LRU.  All runs this backend opens share it — the recording pass
        # then executes once per unique geometry across the whole sweep.
        if isinstance(program_cache, str):
            from repro_torch.simmpi.program import ProgramCache
            program_cache = ProgramCache(
                None if program_cache == "mem" else program_cache)
        self.program_cache = program_cache

    def fingerprint(self) -> dict:
        # custom timing callables cannot be fingerprinted beyond their
        # presence; "custom" still prevents the worst confusion (replaying
        # a deterministic-timer journal as a default-cost-model study).
        # The program cache is deliberately absent: cache-hit replay is
        # bit-identical to re-recording, so it must not split checkpoint
        # identity.
        return {"name": self.name, "overhead": self.overhead,
                "machine": getattr(self.machine, "name", None),
                "timer": "custom" if self.timer is not None else "default",
                "cost_model": "custom" if self.cost_model is not None
                else "default"}

    def point_fingerprints(self, space: SearchSpace) -> Optional[Dict]:
        """Structural fingerprints of every point in ``space`` — what task
        payloads advertise so remote dispatch knows which programs a worker
        already holds.  ``None`` when no program cache is configured."""
        if self.program_cache is None:
            return None
        from repro_torch.simmpi.program import structural_fingerprint
        return {p.name: structural_fingerprint(space.name, p.name, p.params,
                                               space.world_size)
                for p in space.points}

    def open(self, space: SearchSpace, policy: Policy, *,
             seed: int = 0, allocation: int = 0,
             prior=None) -> "SimRun":
        return SimRun(space, policy, machine=self.machine,
                      timer=self.timer, cost_model=self.cost_model,
                      overhead=self.overhead, seed=seed,
                      allocation=allocation, prior=prior,
                      program_cache=self.program_cache)


class SimRun(BackendRun):
    def __init__(self, space: SearchSpace, policy: Policy, *, machine,
                 timer, cost_model, overhead, seed: int, allocation: int,
                 prior=None, program_cache=None):
        # local imports keep repro.api importable without the sim stack
        from repro_torch.core.critter import Critter
        from repro_torch.simmpi.comm import World
        from repro_torch.simmpi.costmodel import CostModel, KNL_STAMPEDE2
        from repro_torch.simmpi.runtime import Runtime

        if not space.world_size:
            raise ValueError(f"space {space.name!r} has no world_size; "
                             "SimBackend needs a virtual machine size")
        from repro_torch.api.transfer import Harvest

        self.policy = policy
        self.world = World(space.world_size)
        self.critter = Critter(self.world, policy)
        if prior:
            self.critter.set_prior(prior.resolver(self.world.size))
        # transfer harvest: measured statistics accumulated across model
        # resets, prior-deduplicated (see transfer.Harvest)
        self._harvest = Harvest(self.world.size, prior)
        cm = cost_model
        if timer is None:
            if cm is None:
                cm = CostModel(machine or space.machine or KNL_STAMPEDE2,
                               allocation=allocation, seed=seed)
            timer = cm.sample
        elif cm is None:
            # a bound CostModel.sample still reveals its machine spec; a
            # fully opaque timer leaves no spec and cost_lower_bound then
            # declines to prune
            owner = getattr(timer, "__self__", None)
            cm = owner if isinstance(owner, CostModel) else None
        self._spec = cm.spec if cm is not None else None
        self.runtime = Runtime(self.world, self.critter, timer,
                               seed=seed + 17 * allocation,
                               overhead=overhead,
                               program_cache=program_cache)
        self._space_name = space.name
        # one program factory per configuration payload, created on first
        # use — its identity keys the runtime's event-trace cache.  Keyed
        # by the payload callable (not the point name) so an ad-hoc point
        # that reuses a study point's name still measures its own program.
        # With a program cache configured, factories are ALSO stamped with
        # their structural fingerprint (``program_key``), switching the
        # runtime to the fingerprint-keyed path: equal geometries share one
        # recording, in-process and across runs — the opt-in trades the
        # payload-identity property for the (name, params)-determine-
        # structure contract of repro.simmpi.program.
        self._progs: Dict[Any, Any] = {}
        self._cached = program_cache is not None
        # point name -> structural fingerprint, for StudyResult.extra
        self._fps: Dict[str, str] = {}
        # structural profiles per payload (see _structure)
        self._structures: Dict[Any, tuple] = {}

    def _prog(self, point: ConfigPoint):
        prog = self._progs.get(point.payload)
        if prog is None:
            prog = self._progs[point.payload] = point.payload(self.world)
            if self._cached:
                from repro_torch.simmpi.program import structural_fingerprint
                fp = structural_fingerprint(self._space_name, point.name,
                                            point.params, self.world.size)
                self._fps[point.name] = prog.program_key = fp
        return prog

    @staticmethod
    def _measure(res) -> Measurement:
        return Measurement(predicted=res.predicted_time,
                           time=res.wall_time, cost=res.wall_time,
                           comp=res.crit_comp, executed=res.executed,
                           skipped=res.skipped)

    def carry_state(self) -> dict:
        # the lognormal sampling stream runs continuously across
        # configurations; a resumed study must pick it up where the
        # interrupted one left off
        return {"rng": self.runtime._rng.bit_generator.state}

    def restore_carry(self, state: Optional[dict]) -> None:
        if state is not None:
            self.runtime._rng.bit_generator.state = state["rng"]

    def export_stats(self) -> dict:
        return self._harvest.payload(self.critter.pooled_kbar())

    def reset_models(self) -> None:
        # bank measured statistics before they are forgotten
        self._harvest.add(self.critter.pooled_kbar())
        self.critter.reset_models()

    def run_reference(self, point: ConfigPoint) -> Measurement:
        res = self.runtime.run(self._prog(point), force_execute=True,
                               update_stats=False)
        return self._measure(res)

    def run_offline(self, point: ConfigPoint) -> Measurement:
        res = self.runtime.run(self._prog(point), force_execute=True,
                               update_stats=True)
        self.critter.snapshot_apriori_counts()
        return self._measure(res)

    def run_trial(self, point: ConfigPoint) -> Measurement:
        return self._measure(self.runtime.run(self._prog(point)))

    # -- model-guided search hooks -------------------------------------------

    def _structure(self, point: ConfigPoint) -> tuple:
        """Structural profile of one configuration via the RNG-free
        recording pass (``Runtime._record`` matches communication without
        touching the Critter protocol or the sampling RNG, so profiling
        any number of candidates leaves measurement state bit-identical):
        per-structural-key per-rank occurrence counts, plus per-rank
        computation flop/byte totals for the roofline bound.  Collectives
        are charged to every participant rank, point-to-points (including
        matched isends) to both endpoints — the per-rank attribution that
        makes ``max`` over ranks a critical-path surrogate."""
        got = self._structures.get(point.payload)
        if got is not None:
            return got
        from repro_torch.core.signatures import (bytes_of, flops_of,
                                           structural_key)
        from repro_torch.simmpi.runtime import (EV_BLOCK, EV_COLL, EV_COMP,
                                          EV_IMATCH, EV_P2P)
        w = self.world.size
        sigs = self.world.interner.sigs
        keys: Dict[int, str] = {}
        counts: Dict[str, np.ndarray] = {}
        flops = np.zeros(w)
        nbytes = np.zeros(w)

        def key_of(sid):
            key = keys.get(sid)
            if key is None:
                key = keys[sid] = structural_key(sigs[sid], w)
            return key

        def bump(key, ranks):
            arr = counts.get(key)
            if arr is None:
                arr = counts[key] = np.zeros(w)
            arr[ranks] += 1.0

        def comp(r, sid):
            bump(key_of(sid), r)
            sig = sigs[sid]
            flops[r] += flops_of(sig)
            nbytes[r] += bytes_of(sig)

        # the COMPILED program, not a raw re-recording: profiling shares
        # the runtime's program map (and the cross-run cache when one is
        # configured), so the model-guided driver scoring the full grid
        # records each unique geometry at most once — and a surviving
        # candidate's later measurement reuses the scorer's program
        for ev in self.runtime._get_program(self._prog(point)).events:
            kind = ev[0]
            if kind == EV_COMP:
                comp(ev[1], ev[2])
            elif kind == EV_BLOCK:
                r = ev[1]
                for sid in ev[2].sids:
                    comp(r, sid)
            elif kind == EV_COLL:
                _, sid, comm = ev
                bump(key_of(sid), comm.ranks_np)
            elif kind == EV_P2P:
                _, src, dst, sid = ev
                key = key_of(sid)
                bump(key, src)
                bump(key, dst)
            elif kind == EV_IMATCH:
                key = key_of(ev[3])
                bump(key, ev[1])
                bump(key, ev[2])
        got = (counts, flops, nbytes)
        self._structures[point.payload] = got
        return got

    def kernel_profile(self, point: ConfigPoint) -> Dict[str, np.ndarray]:
        return self._structure(point)[0]

    def cost_lower_bound(self, point: ConfigPoint) -> Optional[float]:
        if self._spec is None:
            return None
        _, flops, nbytes = self._structure(point)
        per_rank = np.maximum(flops / self._spec.peak_flops,
                              nbytes / self._spec.mem_bw)
        # computation-only: communication at any bandwidth only adds time,
        # so the slowest rank's roofline is a valid lower bound
        return float(per_rank.max()) if per_rank.size else 0.0

    def cache_info(self) -> Optional[dict]:
        if not self._cached:
            return None
        rt = self.runtime
        info = {"fingerprints": dict(self._fps),
                "hits": rt.cache_hits, "misses": rt.cache_misses,
                "recordings": rt.recordings}
        if rt.program_cache is not None:
            info["store"] = rt.program_cache.stats()
        return info


# --------------------------------------------------------------- wall clock

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


# ------------------------------------------------------------------ dry run

class DryRunBackend(Backend):
    """Compile-and-score: ranks configurations by the dominant roofline
    term of their lowered HLO on the production mesh (``tune.dryrun_search``
    machinery).  Deterministic — use ``trials=1``; the "full" and
    "selective" times coincide, so a DryRunBackend study degenerates to a
    ranked table with speedup 1, which is exactly what a cost-model search
    is.  Point payloads are ``tune.dryrun_search.SearchPoint``s.
    """

    name = "dryrun"
    parallel_safe = False     # XLA compiles deadlock in forked children

    def __init__(self, arch: str, shape: str, *, multi_pod: bool = False,
                 cache_dir: Optional[str] = None):
        self.arch = arch
        self.shape = shape
        self.multi_pod = multi_pod
        self.cache_dir = cache_dir

    def fingerprint(self) -> dict:
        return {"name": self.name, "arch": self.arch, "shape": self.shape,
                "multi_pod": self.multi_pod}

    def open(self, space: SearchSpace, policy: Policy, *,
             seed: int = 0, allocation: int = 0,
             prior=None) -> "DryRunRun":
        # a pure cost model keeps no kernel statistics: priors are inert
        return DryRunRun(self)


class DryRunRun(BackendRun):
    def __init__(self, backend: DryRunBackend):
        self.b = backend
        self._recs: Dict[str, dict] = {}

    def reset_models(self) -> None:
        pass                        # nothing accumulates across configs

    def _evaluate(self, point: ConfigPoint) -> dict:
        rec = self._recs.get(point.name)
        if rec is None:
            from repro_torch.tune.dryrun_search import evaluate_point
            try:
                rec = evaluate_point(self.b.arch, self.b.shape,
                                     point.payload,
                                     multi_pod=self.b.multi_pod,
                                     cache_dir=self.b.cache_dir)
            except Exception as e:   # lowering failures are search results
                rec = {"error": repr(e)}
            self._recs[point.name] = rec
        return rec

    def _measure(self, rec: dict) -> Measurement:
        if "error" in rec:
            return Measurement(predicted=float("inf"), time=float("inf"),
                               cost=0.0, extra=dict(rec))
        t = float(rec["roofline"]["step_s"])
        # "full" and "selective" coincide for a pure cost model: each trial
        # charges the modeled step time, so full_cost == selective_cost and
        # the study degenerates to a ranked table with speedup exactly 1
        # (the compile time itself stays available in extra["compile_s"])
        return Measurement(predicted=t, time=t, cost=t, extra=dict(rec))

    def run_reference(self, point: ConfigPoint) -> Measurement:
        return self._measure(self._evaluate(point))

    def run_trial(self, point: ConfigPoint) -> Measurement:
        return self._measure(self._evaluate(point))

    def cost_lower_bound(self, point: ConfigPoint) -> float:
        """The dry-run roofline IS an analytic lower bound: the lowered
        HLO's dominant roofline term at peak rates.  A lowering failure is
        ``+inf`` — dominated by any measured incumbent."""
        rec = self._evaluate(point)
        if "error" in rec:
            return float("inf")
        return float(rec["roofline"]["step_s"])


def dryrun_space(arch: str, shape: str, points) -> SearchSpace:
    """Wrap ``tune.dryrun_search.SearchPoint``s for the session API."""
    return SearchSpace(
        name=f"dryrun-{arch}-{shape}",
        points=[ConfigPoint(name=p.name, params=dict(p.__dict__),
                            payload=p) for p in points],
        reset_between_configs=False)
