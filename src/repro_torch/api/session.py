"""The unified autotuning front-end.

One declarative entry point over every tuning path in the repo::

    from repro.api import AutotuneSession, SimBackend
    from repro.linalg.studies import search_space

    session = AutotuneSession(search_space("capital-cholesky"),
                              backend=SimBackend(),
                              policy="eager", tolerance=0.25)
    result = session.run()            # -> StudyResult

- ``space``    a ``SearchSpace`` (what is tuned);
- ``backend``  a ``Backend`` (how a configuration is measured): sim,
               wall clock, or dry run;
- ``policy`` / ``tolerance``  the paper's selective-execution policy and
               confidence tolerance;
- ``search``   ``"exhaustive"`` (paper protocol) or ``"racing"``
               (CI-driven successive elimination).

``run`` measures one (policy, tolerance) study.  ``sweep`` runs the
paper's policy x tolerance measurement grid through the
``repro.api.scheduler`` work queue: every sweep point is a task with
explicit state, executed on a pluggable executor — in-process (serial),
fork-pool (``workers=N``; bit-identical to the serial run, merged in
grid order), or remote socket workers (``executor=RemoteExecutor([...])``
over ``python -m repro.api.worker`` processes) — and optionally
checkpointed (``checkpoint=path``: completed sweep points — and completed
configurations inside a resumable exhaustive study — are journaled to
JSON and skipped on re-run, so long paper-scale sweeps survive
interruption).

``sweep(share_stats=True)`` streams each completed task's statistics bank
into a shared prior, so sweep points dispatched later warm-start
mid-sweep (already-confident kernels start in the skip regime; eager
pre-switches them off machine-wide).  Shared results depend on completion
order and are journaled under a ``shared_stats`` key; pass
``deterministic=True`` to defer sharing to checkpoint boundaries instead:
tasks of one invocation all run from the bank the checkpoint held at
start (none on the first run — bit-identical to the cold serial driver),
and the banks they harvest only seed the *next* invocation.

Cross-study transfer (``repro.api.transfer``): ``collect_stats=True``
attaches the study's per-kernel statistics bank to
``StudyResult.extra["kernel_stats"]``; ``prior=bank`` (optionally
weakened by ``prior_discount``) seeds a later session's models from it,
so already-confident kernels start in the skip regime.  A warm study's
exported bank folds the transferred prior back in exactly once —
measured evidence is harvested prior-free across model resets
(``transfer.Harvest``), so chained warm-starts do not compound
transferred confidence.  A study resumed mid-way from a checkpoint
exports no bank (the journaled configurations never fed its models).
Priors fingerprint into checkpoint keys: journaled warm results are
never replayed as cold ones (or under a different bank).
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import time
import zlib
from dataclasses import asdict, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.policies import Policy, policy as make_policy

from . import search as _search
from .backends import Backend
from .result import StudyResult
from .scheduler import (FAILED, Executor, ForkExecutor, InProcessExecutor,
                        Scheduler, Task, fork_available)
from .serialize import dumps_canonical
from .space import SearchSpace

_DRIVERS = {"exhaustive": _search.exhaustive, "racing": _search.racing,
            "model_guided": _search.model_guided}

#: sentinel distinguishing "use the session default" from an explicit None
_UNSET = object()


class AutotuneSession:
    """A tuning study bound to a space, a backend, and a protocol."""

    def __init__(self, space: SearchSpace, backend: Backend, *,
                 policy: Union[str, Policy] = "conditional",
                 tolerance: Optional[float] = None,
                 search: str = "exhaustive", trials: int = 3,
                 seed: int = 0, allocation: int = 0,
                 search_options: Optional[dict] = None,
                 prior=None, prior_discount: float = 0.5,
                 prior_max_cv: Optional[float] = None,
                 collect_stats: bool = False,
                 **policy_kwargs):
        if search not in _DRIVERS:
            raise ValueError(f"unknown search {search!r}; "
                             f"want one of {tuple(_DRIVERS)}")
        self.space = space
        self.backend = backend
        self.search = search
        self.trials = trials
        self.seed = seed
        self.allocation = allocation
        # JSON-normalized once, here, so scheduler task payloads ship the
        # options verbatim (model-guided banks/models become their JSON)
        self.search_options = _search.normalize_options(
            search, dict(search_options or {}))
        # cross-study transfer: the per-key quality filter and the discount
        # are applied once, here, so the checkpoint fingerprint below
        # reflects the evidence actually seeded; an empty (or None) prior
        # is exactly a cold session.  ``prior_max_cv`` drops bank entries
        # whose dispersion betrays a pooled mixture (byte-bucketed comm
        # keys pooling several configurations' message sizes) — see
        # ``StatisticsBank.filtered``.
        if prior is not None and prior_max_cv is not None:
            prior = prior.filtered(max_cv=prior_max_cv)
        self.prior = prior.discounted(prior_discount) \
            if prior is not None and len(prior) else None
        self.prior_discount = prior_discount
        self.prior_max_cv = prior_max_cv
        self.collect_stats = bool(collect_stats)
        #: recovery events of the most recent sweep (retries, worker
        #: loss/join, deadlines) — also journaled to the checkpoint
        self.last_sweep_events: List[dict] = []
        if isinstance(policy, Policy):
            self._base_policy = policy if tolerance is None \
                else replace(policy, tolerance=tolerance)
        else:
            self._base_policy = make_policy(
                policy, tolerance=0.25 if tolerance is None else tolerance,
                **policy_kwargs)

    # -- policy resolution ---------------------------------------------------

    def _policy(self, name: Optional[str] = None,
                tolerance: Optional[float] = None) -> Policy:
        pol = self._base_policy
        if name is not None and name != pol.name:
            # carry every other policy field (min_samples, vote fraction,
            # extrapolate) across the sweep grid — a sweep must compare
            # policies under one statistical setting
            pol = replace(pol, name=name)
        if tolerance is not None:
            pol = replace(pol, tolerance=tolerance)
        return pol

    # -- one study -----------------------------------------------------------

    def _key(self, pol: Policy, seed: int, allocation: int, *,
             prior=_UNSET, collect=None, shared=False) -> dict:
        if prior is _UNSET:
            prior = self.prior
        if collect is None:
            collect = self.collect_stats
        key = {"space": self.space.name, "n_points": len(self.space),
               "backend": self.backend.fingerprint(),
               "policy": pol.name,
               "tolerance": pol.tolerance, "trials": self.trials,
               "search": self.search, "seed": seed,
               "allocation": allocation}
        if self.search_options:
            # driver options change what a study measures (racing rounds,
            # model-guided banks/seed/coverage): journaled results must
            # never be replayed across different options.  Fingerprinted —
            # a bank in the options would otherwise bloat every key.
            key["search_options"] = "opts:%08x" % zlib.crc32(
                dumps_canonical(self.search_options).encode())
        # only non-default transfer settings enter the key, so existing
        # cold checkpoints keep resolving under their original identity
        if shared:
            # statistics-sharing sweeps: the prior a task ran under depends
            # on completion order (live mode) or on which invocation first
            # dispatched it (deterministic mode), so shared results carry a
            # mode marker (True | "deterministic") instead of a bank
            # fingerprint — resumption reuses them, and the key still
            # prevents replaying them as cold results (or across modes)
            key["shared_stats"] = shared
        elif prior is not None:
            key["prior"] = prior.fingerprint()
        if collect:
            key["collect_stats"] = True
        return key

    def _run_one(self, pol: Policy, seed: int, allocation: int, *,
                 checkpoint: Optional["_Checkpoint"] = None,
                 prior=_UNSET, collect=None, shared=False) -> StudyResult:
        if prior is _UNSET:
            prior = self.prior
        if collect is None:
            collect = self.collect_stats
        t0 = time.time()
        run = self.backend.open(self.space, pol, seed=seed,
                                allocation=allocation, prior=prior)
        driver = _DRIVERS[self.search]
        opts = dict(self.search_options)
        key = self._key(pol, seed, allocation, prior=prior,
                        collect=collect, shared=shared)
        start = None
        if checkpoint is not None and not shared \
                and self.search == "exhaustive" \
                and self.space.should_reset(pol):
            # per-configuration journaling is protocol-safe only when
            # statistics reset between configurations: a fresh backend at
            # point k is then in the same state as one that measured
            # points 0..k-1 — up to the backend's carry state (the sim
            # RNG stream), journaled with every record and restored here
            # (anything else resumes whole studies only).  Mid-sweep-shared
            # tasks never journal partial records: a re-dispatched task may
            # run under a different evolved prior than the killed one.
            start, carry = checkpoint.partial(key)
            if start:
                run.restore_carry(carry)
            opts["start_records"] = start
            opts["on_record"] = lambda rec: checkpoint.add_record(
                key, rec, run.carry_state())
        if self.search == "model_guided":
            if prior is not None and "banks" not in opts \
                    and "model" not in opts:
                # the seeded prior doubles as the candidate model unless
                # the caller supplied explicit banks — mid-sweep shared
                # statistics thereby sharpen later tasks' samplers, not
                # just their skip regimes
                opts["banks"] = [prior.to_json()]
            if checkpoint is not None and not shared:
                # the candidate selection (survivor set + post-selection
                # sampler RNG) is journaled so a killed-and-resumed study
                # re-races the same survivors without re-consuming sampler
                # draws — bit-identical to the uninterrupted driver
                st = checkpoint.search_state(key)
                if st is not None:
                    opts["start_state"] = st
                opts["on_state"] = \
                    lambda s: checkpoint.add_search_state(key, s)
        records, extra = driver(run, self.space, pol, trials=self.trials,
                                **opts)
        if collect and not start:
            # configurations replayed from a checkpoint journal never fed
            # this run's models, so a resumed study cannot export the full
            # posterior — omit the bank rather than present a partial one
            # (resume the study without collect_stats, or re-run cold, to
            # obtain a complete bank)
            bank = run.export_stats()
            if bank is not None:
                extra = dict(extra)
                extra["kernel_stats"] = bank
        cache_info = run.cache_info()
        if cache_info is not None:
            # program-cache provenance: per-point structural fingerprints
            # plus this task's hit/miss/recording counters, so the nightly
            # drift gate can attribute changes to code vs cached artifact
            extra = dict(extra)
            extra["program_cache"] = cache_info
        result = StudyResult(
            study=self.space.name, policy=pol.name,
            tolerance=pol.tolerance, records=records,
            full_tuning_time=sum(r.full_cost for r in records),
            selective_tuning_time=sum(r.selective_cost for r in records),
            backend=self.backend.name, search=self.search, seed=seed,
            allocation=allocation, wall_s=round(time.time() - t0, 3),
            extra=extra)
        return result

    def run(self, *, checkpoint: Optional[str] = None) -> StudyResult:
        """Run the study; with ``checkpoint``, resume a partial one."""
        pol = self._policy()
        if checkpoint is None:
            return self._run_one(pol, self.seed, self.allocation)
        ck = _Checkpoint(checkpoint)
        key = self._key(pol, self.seed, self.allocation)
        done = ck.result_for(key)
        if done is not None:
            return done
        result = self._run_one(pol, self.seed, self.allocation,
                               checkpoint=ck)
        ck.add_result(key, result)
        return result

    # -- policy x tolerance sweeps -------------------------------------------

    def _task_payload(self, spec, prior, *, collect: bool,
                      shared) -> dict:
        """The JSON-able task message executors ship (see ``run_payload``:
        self-describing, so a remote worker reconstructs the exact study
        from it and its own (space, backend))."""
        payload = {"policy": asdict(self._policy(spec[0], spec[1])),
                   "seed": spec[2], "allocation": spec[3],
                   "search": self.search, "trials": self.trials,
                   "search_options": self.search_options,
                   "prior": prior.to_json() if prior is not None else None,
                   "collect": collect, "shared": shared}
        fps = getattr(self.backend, "point_fingerprints", None)
        if fps is not None:
            # structural fingerprints of the points this task will measure:
            # a worker holding a program under the same fingerprint replays
            # it instead of re-recording, and a worker computing a
            # DIFFERENT fingerprint for the same point name refuses the
            # task loudly (geometry drift between dispatcher and worker)
            fps = fps(self.space)
            if fps:
                payload["program_fingerprints"] = fps
        return payload

    def _select_executor(self, workers: int, n_tasks: int) -> Executor:
        if workers > 1 and n_tasks > 1 and fork_available() \
                and getattr(self.backend, "parallel_safe", True):
            return ForkExecutor(min(workers, n_tasks))
        # jax/wall-clock backends measure serially regardless of workers
        return InProcessExecutor()

    def sweep(self, *, policies: Optional[Sequence[str]] = None,
              tolerances: Optional[Sequence[float]] = None,
              seeds: Sequence[int] = (0,),
              allocations: Sequence[int] = (0,),
              workers: int = 1,
              checkpoint: Optional[str] = None,
              executor: Optional[Executor] = None,
              share_stats: bool = False,
              deterministic: bool = False,
              max_retries: int = 0,
              retry_backoff: float = 0.25,
              on_failure: str = "raise",
              driver: Optional[str] = None) -> List[StudyResult]:
        """The paper's measurement grid (§VI.A): one independent study per
        (policy, tolerance, seed, allocation), scheduled as tasks on an
        executor (``workers`` forks; pass ``executor=`` for remote
        workers) and merged in grid order.

        ``share_stats=True`` streams completed tasks' statistics banks
        into a shared prior seeding later-dispatched tasks mid-sweep;
        ``deterministic=True`` defers that sharing to checkpoint
        boundaries (tasks only warm-start from banks a *previous*
        invocation persisted to the checkpoint), keeping each invocation
        bit-identical to the serial driver under the same seed bank.

        ``driver`` overrides the session's search for this sweep only
        (``sweep(driver="model_guided")``): sampled-candidate sweeps ride
        the same checkpointing, mid-sweep statistics sharing, and
        fork/remote executors as exhaustive ones — the sampler seed ships
        in each task payload and its post-selection RNG state is journaled
        with the study, so killed-and-resumed or fork-dispatched sweeps
        stay bit-identical to the serial driver.

        Failure semantics (fleet sweeps): a failed sweep point (worker
        death, task deadline, task exception) is retried up to
        ``max_retries`` times with exponential backoff
        (``retry_backoff * 2**(n-1)`` seconds); the retried task's payload
        is rebuilt at re-dispatch, so deterministic sweeps stay
        bit-identical to the serial driver.  When retries are exhausted,
        ``on_failure="raise"`` (default) raises ``SchedulerError`` with
        the full attempt history, while ``on_failure="skip"`` leaves that
        grid slot ``None`` in the returned list and journals the failure
        (with its attempt history) into the checkpoint — a later
        invocation with the same checkpoint re-attempts exactly the
        failed points.  Every recovery event (retry, worker loss/join,
        deadline, heartbeat timeout) is journaled into the checkpoint's
        ``events`` list and kept on ``self.last_sweep_events``; a result
        that needed retries carries them in
        ``StudyResult.extra["recovery"]``, so downstream drift analysis
        can attribute anomalies to infrastructure."""
        if driver is not None and driver != self.search:
            # sweep-scoped search override (sweep(driver="model_guided")):
            # the study key and task payloads both read self.search, so
            # rebind it (and re-normalize options for the new driver) for
            # the duration of this sweep only
            if driver not in _DRIVERS:
                raise ValueError(f"unknown search {driver!r}; "
                                 f"want one of {tuple(_DRIVERS)}")
            prev, prev_opts = self.search, self.search_options
            self.search = driver
            self.search_options = _search.normalize_options(
                driver, dict(prev_opts))
            try:
                return self.sweep(
                    policies=policies, tolerances=tolerances, seeds=seeds,
                    allocations=allocations, workers=workers,
                    checkpoint=checkpoint, executor=executor,
                    share_stats=share_stats, deterministic=deterministic,
                    max_retries=max_retries, retry_backoff=retry_backoff,
                    on_failure=on_failure)
            finally:
                self.search, self.search_options = prev, prev_opts
        policies = list(policies) if policies is not None \
            else [self._base_policy.name]
        tolerances = list(tolerances) if tolerances is not None \
            else [self._base_policy.tolerance]
        grid = list(itertools.product(policies, tolerances, seeds,
                                      allocations))
        ck = _Checkpoint(checkpoint) if checkpoint else None
        shared = _SharedStats(self, ck, frozen=deterministic) \
            if share_stats else None
        shared_mode = False if not share_stats \
            else ("deterministic" if deterministic else True)
        # mid-sweep sharing needs every task to harvest a bank; the bank is
        # stripped from results again unless the caller asked for it
        collect = self.collect_stats or share_stats

        results: List[Optional[StudyResult]] = [None] * len(grid)
        keys: List[dict] = []
        todo: List[Tuple[int, tuple]] = []
        for i, spec in enumerate(grid):
            pol = self._policy(spec[0], spec[1])
            key = self._key(pol, spec[2], spec[3],
                            collect=collect, shared=shared_mode)
            keys.append(key)
            done = ck.result_for(key) if ck else None
            if done is not None:
                results[i] = done
            else:
                todo.append((i, spec))

        if executor is None:
            executor = self._select_executor(workers, len(todo))
        # serial in-process execution journals inside each study too
        # (per-config records survive a kill mid-study); forked/remote
        # workers cannot share the journal file, so those checkpoint whole
        # points; _run_one additionally refuses partial journaling for
        # live-shared tasks (the re-dispatch prior may differ)
        inflight_ck = ck if isinstance(executor, InProcessExecutor) \
            else None

        def prepare(task: Task) -> dict:
            _, spec = task.spec
            prior = shared.current() if shared else self.prior
            return self._task_payload(spec, prior, collect=collect,
                                      shared=shared_mode)

        def runner(payload: dict) -> dict:
            return run_payload(self.space, self.backend, payload,
                               checkpoint=inflight_ck,
                               session=self)

        events: List[dict] = []

        def on_event(ev: dict) -> None:
            events.append(ev)
            if ck:
                ck.add_event(ev)

        def on_done(task: Task) -> None:
            i, _ = task.spec
            res = task.result
            pc = res.get("extra", {}).get("program_cache")
            if pc:
                # journal the task's program-cache counters: summing
                # ``recordings`` across a sweep's events shows how many
                # structural passes actually ran (the record-once-per-
                # geometry acceptance counter: N tasks -> N_unique)
                on_event({"event": "program_cache", "task": i,
                          "hits": pc.get("hits", 0),
                          "misses": pc.get("misses", 0),
                          "recordings": pc.get("recordings", 0)})
            bank_json = res.get("extra", {}).get("kernel_stats")
            if shared is not None:
                shared.add(bank_json)
            if collect and not self.collect_stats and bank_json:
                res["extra"].pop("kernel_stats", None)
            if task.attempts:
                # infrastructure provenance: this point only succeeded
                # after recovery — surfaced so drift analysis can tell
                # fleet trouble from protocol change
                res.setdefault("extra", {})["recovery"] = {
                    "retries": len(task.attempts),
                    "attempts": task.attempts}
            results[i] = StudyResult.from_json(res)
            if ck:
                ck.add_result(keys[i], results[i])

        done = Scheduler(executor, runner, max_retries=max_retries,
                         retry_backoff=retry_backoff,
                         on_failure=on_failure,
                         on_event=on_event).run(todo, prepare=prepare,
                                                on_done=on_done)
        # on_failure="skip": exhausted points stay None in the merged list
        # and their attempt histories are journaled, so a resumed sweep
        # re-attempts exactly these
        for task in done:
            if task.state == FAILED:
                i, _ = task.spec
                if ck:
                    ck.add_failure(keys[i], task.attempts)
        self.last_sweep_events = events
        return list(results)


# ------------------------------------------------------------ task runner

def run_payload(space: SearchSpace, backend: Backend, payload: dict, *,
                checkpoint: Optional["_Checkpoint"] = None,
                session: Optional[AutotuneSession] = None) -> dict:
    """Execute one scheduler task payload (``AutotuneSession._task_payload``
    shape) against a (space, backend) pair, returning the study-result
    JSON.  This is the single task-execution entry point shared by the
    in-process/fork runners (which pass their live ``session``) and the
    remote worker (which builds a fresh, equivalent session from the
    payload — it is self-describing: full policy fields, search, trials,
    prior bank, transfer flags)."""
    pol = Policy(**payload["policy"])
    sent = payload.get("program_fingerprints")
    if sent:
        # geometry-drift guard: the dispatcher's structural fingerprints
        # must match what this (space, backend) computes for the same
        # point names — a mismatch means the two sides hold different
        # geometries under one name, and a cached program replayed across
        # that divide would be silently wrong
        mine = getattr(backend, "point_fingerprints", lambda s: None)(space)
        if mine:
            drift = {name: (fp, mine[name]) for name, fp in sent.items()
                     if name in mine and mine[name] != fp}
            if drift:
                detail = ", ".join(
                    f"{name}: dispatcher {theirs} vs worker {ours}"
                    for name, (theirs, ours) in sorted(drift.items())[:4])
                raise ValueError(
                    f"program fingerprint mismatch on {len(drift)} "
                    f"point(s) of space {space.name!r} ({detail}); "
                    f"refusing to measure a drifted geometry")
    if session is None:
        session = AutotuneSession(
            space, backend, policy=pol,
            search=payload.get("search", "exhaustive"),
            trials=payload.get("trials", 3),
            search_options=payload.get("search_options"))
    prior = None
    if payload.get("prior"):
        from .transfer import StatisticsBank
        bank = StatisticsBank.from_json(payload["prior"])
        prior = bank if len(bank) else None
    return session._run_one(
        pol, payload["seed"], payload["allocation"], checkpoint=checkpoint,
        prior=prior, collect=payload.get("collect", False),
        shared=payload.get("shared", False)).to_json()


class _SharedStats:
    """Mid-sweep statistics sharing: the accumulator completed tasks feed
    and later dispatches seed from.

    ``add`` merges a completed task's harvested bank into the running
    accumulator and persists it to the checkpoint (``shared_bank`` entry),
    so a killed sweep resumes with the shared prior rebuilt.  ``current``
    assembles the dispatch prior: the accumulator — filtered by the
    session's ``prior_max_cv`` and weakened by its ``prior_discount``,
    exactly like a static ``prior=`` bank — merged over the session's own
    static prior.  With ``frozen=True`` (``deterministic`` sweeps) the
    dispatch prior is pinned to the accumulator state loaded at
    construction (the checkpoint boundary); completions still accumulate
    and persist, but only seed the *next* invocation."""

    def __init__(self, session: AutotuneSession,
                 ck: Optional["_Checkpoint"], *, frozen: bool):
        from .transfer import StatisticsBank
        self._session = session
        self._ck = ck
        self._frozen = frozen
        loaded = ck.shared_bank() if ck else None
        self._acc = loaded if loaded is not None else StatisticsBank()
        self._seed_prior = self._assemble(self._acc)

    def _assemble(self, bank):
        s = self._session
        if not bank:
            return s.prior
        if s.prior_max_cv is not None:
            bank = bank.filtered(max_cv=s.prior_max_cv)
        bank = bank.discounted(s.prior_discount)
        if not bank:
            return s.prior
        return s.prior.merge(bank) if s.prior is not None else bank

    def current(self):
        """The prior a task dispatched right now seeds from."""
        return self._seed_prior if self._frozen else self._assemble(
            self._acc)

    def add(self, bank_json: Optional[dict]) -> None:
        if not bank_json:
            return                  # task harvested nothing (e.g. dry run)
        from .transfer import StatisticsBank
        self._acc = self._acc.merge(StatisticsBank.from_json(bank_json))
        if self._ck is not None:
            self._ck.set_shared_bank(self._acc)


# ----------------------------------------------------------------- journal

class _Checkpoint:
    """JSON journal of completed studies / configuration records.

    One file holds a dict keyed by the study key's canonical JSON:
    ``{"results": {key: result_json},
       "records": {key: {"recs": [record_json], "carry": state}},
       "search_state": {key: selection_json},
       "shared_bank": bank_json,
       "failures": {key: {"attempts": [...]}},
       "events": [event, ...]}`` — ``search_state`` is a model-guided
    study's journaled candidate selection (survivor set, roofline prunes,
    post-selection sampler RNG state, space order fingerprint), cleared
    when the study's result lands; ``shared_bank`` is the accumulated
    mid-sweep statistics bank of ``share_stats`` sweeps, so a resumed
    sweep restores the shared prior its killed predecessor had earned;
    ``failures`` are sweep points whose retries were exhausted under
    ``on_failure="skip"`` (kept with their attempt history; a completed
    re-attempt supersedes the entry) and ``events`` is the recovery
    journal (retries, worker loss/join/restart, timeouts).

    Writes are crash-safe: each flush serializes into a uniquely-named
    temp file in the destination directory, fsyncs it, and atomically
    ``os.replace``s it into place — a worker/driver killed mid-write can
    never leave a truncated journal that blocks resume, and concurrent
    flushers cannot trample each other's temp file.
    """

    def __init__(self, path: str):
        self.path = path
        self._data: Dict[str, Any] = {"results": {}, "records": {}}
        if os.path.exists(path):
            with open(path) as f:
                loaded = json.load(f)
            if not isinstance(loaded, dict) or "results" not in loaded:
                raise ValueError(f"{path}: not a session checkpoint file")
            self._data = loaded
            self._data.setdefault("records", {})

    @staticmethod
    def _k(key: dict) -> str:
        # one canonical identity string per key (shared with bank
        # fingerprints); tolerates tuples/NumPy scalars in key values
        return dumps_canonical(key)

    def _flush(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self.path) + ".", suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def result_for(self, key: dict) -> Optional[StudyResult]:
        got = self._data["results"].get(self._k(key))
        return StudyResult.from_json(got) if got is not None else None

    def add_result(self, key: dict, result: StudyResult) -> None:
        k = self._k(key)
        self._data["results"][k] = result.to_json()
        self._data["records"].pop(k, None)   # subsumed by the full result
        self._data.get("search_state", {}).pop(k, None)
        # a completed re-attempt supersedes a journaled failure
        self._data.get("failures", {}).pop(k, None)
        self._flush()

    def add_failure(self, key: dict, attempts: List[dict]) -> None:
        """Journal an exhausted-retries sweep point (``on_failure="skip"``)
        with its full attempt history; the point is NOT treated as done —
        a resumed sweep re-attempts it."""
        self._data.setdefault("failures", {})[self._k(key)] = {
            "attempts": attempts}
        self._flush()

    def failure_for(self, key: dict) -> Optional[dict]:
        """The journaled failure entry for a sweep point, or ``None``."""
        return self._data.get("failures", {}).get(self._k(key))

    def add_event(self, event: dict) -> None:
        """Append one recovery event (retry, worker loss/join/restart,
        heartbeat/deadline timeout) to the sweep's journal."""
        self._data.setdefault("events", []).append(event)
        self._flush()

    def events(self) -> List[dict]:
        return list(self._data.get("events", []))

    def partial(self, key: dict):
        """(records-so-far, carry-state-after-the-last-one)."""
        from .result import ConfigRecord
        got = self._data["records"].get(self._k(key))
        if not got:
            return [], None
        return ([ConfigRecord.from_json(r) for r in got["recs"]],
                got.get("carry"))

    def add_record(self, key: dict, record, carry=None) -> None:
        entry = self._data["records"].setdefault(
            self._k(key), {"recs": [], "carry": None})
        entry["recs"].append(record.to_json())
        entry["carry"] = carry
        self._flush()

    def search_state(self, key: dict) -> Optional[dict]:
        """The journaled model-guided candidate selection (survivor set +
        post-selection sampler RNG + space order fingerprint), or
        ``None``.  Cleared when the study's full result lands."""
        return self._data.get("search_state", {}).get(self._k(key))

    def add_search_state(self, key: dict, state: dict) -> None:
        self._data.setdefault("search_state", {})[self._k(key)] = state
        self._flush()

    def shared_bank(self):
        """The accumulated mid-sweep statistics bank, or ``None``."""
        got = self._data.get("shared_bank")
        if not got:
            return None
        from .transfer import StatisticsBank
        return StatisticsBank.from_json(got)

    def set_shared_bank(self, bank) -> None:
        self._data["shared_bank"] = bank.to_json()
        self._flush()
