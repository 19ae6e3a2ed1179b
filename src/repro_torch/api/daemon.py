"""Always-on autotuning daemon: continuous selective tuning of live traffic.

One-shot studies assume the workload is known up front; a serving fleet is
the opposite — request *shapes* (batch, sequence bucket, architecture)
arrive over time, recur at wildly different rates, and the machine's
timing behaviour slowly drifts underneath them.  This module turns the
session machinery into a long-lived service around four pieces:

- **shape router** (``TuningDaemon.route``): every request shape maps to a
  study key in the world-independent structural-key namespace
  (``core.signatures.structural_key`` — the same identity space the
  statistics bank uses).  An unknown shape opens a per-shape
  ``AutotuneSession`` supplied by the *provider*; a tuned shape serves
  with its winning configuration.
- **fleet profile store** (``FleetStore``): one shared, persistent
  ``StatisticsBank`` absorbing every completed study's harvest.  Entries
  carry ``KernelStats.last_updated`` stamps; the warm-start prior handed
  to new studies is an age-decayed view (``discount_by_age``: evidence
  halves every ``half_life`` seconds, entries beyond ``evidence_ttl`` are
  dropped), so stale fleet knowledge re-earns confidence instead of being
  trusted forever.
- **drift detector** (``DriftDetector``): serving keeps charging live
  per-kernel timings through ``SelectiveTimer`` in shadow mode (every
  ``shadow_every``-th serving step force-executes each kernel once, even
  in the skip regime).  When a kernel's live mean exits its stored confidence
  interval (configurable ``drift_z`` / ``drift_min_samples``), the paper's
  predictability verdict has failed in reverse — the evidence is stale:
  the entry is evicted and every shape whose winner depends on that
  kernel is re-armed for tuning.
- **background re-tunes** (``BackgroundTuner``): studies run off the
  serve loop, each through ``repro.api.scheduler`` (``Scheduler`` +
  pluggable executor — in-process, fork, or remote — with the retry /
  heartbeat machinery), and completed winners are atomically swapped into
  the router by ``pump``.  Serving never stops: a re-tuning shape keeps
  serving its previous winner until the new one lands.

The daemon is generic over a *provider* object binding it to a concrete
study family (duck-typed):

- ``session_for(key, meta, prior) -> AutotuneSession`` — the per-shape
  study (``collect_stats=True`` so its harvest feeds the fleet store);
- ``kernels_for(key, meta, winner_name) -> [(Signature, thunk, freq)]``
  — the winner's serving-side kernel occurrence list;
- ``kernel_keys(key, meta, winner_name) -> [str]`` — the structural keys
  the winner depends on (drift re-arm fan-out), computable without
  compiling.

``repro.serve.tuner`` is the LM-serving binding.  Daemon state (winners,
fleet bank, event journal, in-flight studies) checkpoints atomically and
restores across restarts.
"""

from __future__ import annotations

import math
import os
import queue as _queue
import tempfile
import threading
import time
import traceback
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.policies import Policy, policy as make_policy
from repro_torch.core.signatures import Signature, structural_key
from repro_torch.core.stats import KernelStats

from .result import StudyResult
from .scheduler import Executor, InProcessExecutor, Scheduler
from .session import AutotuneSession, run_payload
from .transfer import StatisticsBank

DAEMON_VERSION = 1

#: shape lifecycle states (``TuningDaemon.state``)
MISS = "miss"            # never seen (transient; returned by route only)
TUNING = "tuning"        # first study in flight, serving untuned
TUNED = "tuned"          # winner installed
RETUNING = "retuning"    # drift re-tune in flight, serving the old winner


@dataclass
class DaemonConfig:
    """Daemon-level knobs (study-level knobs live on the provider)."""

    #: serving-side selective policy; eager pre-switches banked-confident
    #: kernels off machine-wide, so a tuned shape's second occurrence runs
    #: zero kernels for banked signatures
    serve_policy: str = "eager"
    serve_tolerance: float = 0.25
    serve_min_samples: int = 2
    #: fleet evidence half-life (seconds) for the age-decayed prior view
    half_life: float = 3600.0
    #: drop fleet entries older than this many seconds (None = never)
    evidence_ttl: Optional[float] = None
    #: every Nth serving step of a shape is a shadow step force-executing
    #: one occurrence of each kernel; 0 disables shadow sampling (and
    #: with it drift detection)
    shadow_every: int = 8
    #: drift verdict: live mean outside z * stored-std/sqrt(n), after at
    #: least min_samples live shadow samples; window bounds the live run
    drift_z: float = 4.0
    drift_min_samples: int = 4
    drift_window: int = 64
    #: background-study retry policy (``repro.api.scheduler``)
    max_retries: int = 1
    retry_backoff: float = 0.05
    #: run studies inline inside ``submit`` (deterministic tests) instead
    #: of on the background thread — same Scheduler path either way
    synchronous: bool = False


# ---------------------------------------------------------------- fleet store

class FleetStore:
    """The fleet-wide kernel profile store: one ``StatisticsBank`` shared
    by every shape's study, with wall-clock evidence aging.

    ``absorb`` merges a completed study's harvest (stamping new evidence
    with the current time); ``record`` accrues a single live shadow
    sample; ``prior`` is the age-decayed warm-start view handed to new
    studies; ``evict`` drops entries the drift detector has invalidated.
    Persistence goes through ``StatisticsBank.save`` (mkstemp + fsync +
    atomic replace), so a crash mid-flush can never corrupt the bank.
    """

    def __init__(self, bank: Optional[StatisticsBank] = None, *,
                 clock: Callable[[], float] = time.time,
                 half_life: float = 3600.0, ttl: Optional[float] = None):
        self.bank = bank if bank is not None else StatisticsBank()
        self.clock = clock
        self.half_life = half_life
        self.ttl = ttl
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.bank)

    def prior(self) -> StatisticsBank:
        """Age-decayed warm-start view (a new bank; the store unchanged)."""
        with self._lock:
            return self.bank.discount_by_age(self.clock(), self.half_life,
                                             ttl=self.ttl)

    def absorb(self, bank: Optional[StatisticsBank]) -> int:
        """Merge a harvest in, stamping its unstamped entries with now."""
        if not bank:
            return 0
        inc = StatisticsBank({k: v.copy() for k, v in bank.entries.items()},
                             meta=list(bank.meta))
        inc.stamp(self.clock())
        with self._lock:
            self.bank = self.bank.merge(inc)
        return len(inc)

    def record(self, key: str, t: float) -> None:
        """Accrue one live shadow sample into the store (fresh stamp)."""
        with self._lock:
            st = self.bank.entries.get(key)
            if st is None:
                st = self.bank.entries[key] = KernelStats()
            st.update(t)
            st.last_updated = self.clock()

    def reference(self, key: str) -> Optional[KernelStats]:
        with self._lock:
            st = self.bank.entries.get(key)
            return st.copy() if st is not None else None

    def evict(self, keys: Sequence[str]) -> int:
        with self._lock:
            n = 0
            for k in keys:
                if self.bank.entries.pop(k, None) is not None:
                    n += 1
            return n

    def save(self, path: str) -> None:
        with self._lock:
            self.bank.save(path)

    def load(self, path: str) -> None:
        bank = StatisticsBank.load(path)
        with self._lock:
            self.bank = bank


# -------------------------------------------------------------- drift detector

class DriftDetector:
    """The predictability verdict run in reverse: evidence going stale.

    Per kernel key, live shadow samples accumulate in a window whose
    reference — the stored mean and a ``z * std / sqrt(n)`` half-width —
    is snapshotted from the fleet store when the window opens.  Once the
    window holds ``min_samples`` live samples, a live mean outside the
    reference interval is drift; the window also recycles after
    ``window`` samples so the reference tracks accepted evidence.
    """

    def __init__(self, store: FleetStore, *, z: float = 4.0,
                 min_samples: int = 4, window: int = 64):
        self.store = store
        self.z = z
        self.min_samples = max(int(min_samples), 1)
        self.window = max(int(window), self.min_samples)
        self._ref: Dict[str, Tuple[float, float]] = {}
        self._live: Dict[str, KernelStats] = {}

    def reset(self, key: str) -> None:
        self._ref.pop(key, None)
        self._live.pop(key, None)

    def observe(self, key: str, t: float) -> bool:
        """Fold one live sample; True exactly when drift is declared."""
        ref = self._ref.get(key)
        if ref is None:
            st = self.store.reference(key)
            if st is None or st.n < 2:
                return False            # nothing stored to drift from
            hw = self.z * st.std / math.sqrt(st.n)
            if not math.isfinite(hw):
                return False
            ref = self._ref[key] = (st.mean, hw)
            self._live[key] = KernelStats()
        live = self._live[key]
        live.update(t)
        if live.n < self.min_samples:
            return False
        drifted = abs(live.mean - ref[0]) > ref[1]
        if drifted or live.n >= self.window:
            self.reset(key)             # next sample opens a fresh window
        return drifted


# ------------------------------------------------------------------ checkpoint

class DaemonCheckpoint:
    """Atomic JSON snapshot of daemon state — the ``_Checkpoint._flush``
    durability discipline (same-directory mkstemp, fsync, ``os.replace``):
    a daemon killed mid-save leaves either the old snapshot or the new
    one, never a truncated hybrid."""

    @staticmethod
    def save(path: str, data: dict) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".", suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @staticmethod
    def load(path: str) -> dict:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) \
                or data.get("version") != DAEMON_VERSION:
            raise ValueError(f"{path}: not a daemon checkpoint "
                             f"(want version {DAEMON_VERSION})")
        return data


# ------------------------------------------------------------ background tuner

class BackgroundTuner:
    """Runs per-shape studies off the serve loop, each through the
    scheduler subsystem (retries/backoff, recovery events, pluggable
    executors — ``executor_factory`` builds a fresh executor per study, so
    fork pools and remote fleets plug in unchanged).

    ``submit`` enqueues; a single worker thread drains jobs (one study at
    a time — wall-clock backends measure serially); ``drain`` returns
    completed ``(key, tag, result_json | None, error | None)`` tuples for
    the daemon's ``pump`` to apply.  ``synchronous=True`` runs the study
    inline inside ``submit`` through the *same* Scheduler path
    (deterministic tests, fork-vs-in-process parity checks).
    """

    def __init__(self, *, executor_factory: Optional[
                     Callable[[], Executor]] = None,
                 max_retries: int = 1, retry_backoff: float = 0.05,
                 on_event: Optional[Callable[[dict], None]] = None,
                 synchronous: bool = False):
        self.executor_factory = executor_factory or InProcessExecutor
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.on_event = on_event
        self.synchronous = synchronous
        self._jobs: _queue.Queue = _queue.Queue()
        self._done: _queue.Queue = _queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def submit(self, key: str, session: AutotuneSession, *,
               tag: str = "tune") -> None:
        job = (key, session, self._payload(session), tag)
        if self.synchronous:
            self._run(job)
            return
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="repro-daemon-tuner", daemon=True)
            self._thread.start()
        self._jobs.put(job)

    @staticmethod
    def _payload(session: AutotuneSession) -> dict:
        pol = session._policy()
        return session._task_payload(
            (pol.name, pol.tolerance, session.seed, session.allocation),
            session.prior, collect=True, shared=False)

    def _run(self, job) -> None:
        key, session, payload, tag = job
        executor = self.executor_factory()

        def runner(p: dict) -> dict:
            return run_payload(session.space, session.backend, p,
                               session=session)

        try:
            tasks = Scheduler(executor, runner,
                              max_retries=self.max_retries,
                              retry_backoff=self.retry_backoff,
                              on_failure="raise",
                              on_event=self.on_event).run(
                [(0, key)], prepare=lambda task: payload)
            self._done.put((key, tag, tasks[0].result, None))
        except Exception:
            self._done.put((key, tag, None, traceback.format_exc()))

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            self._run(job)

    def drain(self) -> List[Tuple[str, str, Optional[dict], Optional[str]]]:
        out = []
        while True:
            try:
                out.append(self._done.get_nowait())
            except _queue.Empty:
                return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join(timeout=30.0)


# ------------------------------------------------------------ per-shape server

class _ShapeServer:
    """Serving-side selective timer for one tuned shape.

    Kernels run through a ``SelectiveTimer`` seeded from the fleet prior
    (eager serving pre-switches banked-confident kernels off), except
    that every ``shadow_every``-th serving step is a *shadow step*: the
    first occurrence of each kernel in it is force-executed — a real
    measured sample that keeps live evidence flowing to the drift
    detector after the skip regime is reached, while non-shadow steps
    (including a tuned shape's first and second) run banked kernels zero
    times.
    """

    def __init__(self, kernels, policy: Policy, prior: StatisticsBank,
                 clock: Callable[[], float], shadow_every: int):
        from repro_torch.tune.selective import SelectiveTimer
        self.kernels = list(kernels)
        self.shadow_every = int(shadow_every)
        self.timer = SelectiveTimer(
            policy, clock=clock,
            prior_lookup=prior.resolver(1) if prior else None)
        self.banked: Set[str] = set(prior.entries) if prior else set()
        self._steps = 0
        self._keys: Dict[Signature, str] = {}

    def _key(self, sig: Signature) -> str:
        k = self._keys.get(sig)
        if k is None:
            k = self._keys[sig] = structural_key(sig, 1)
        return k

    def step(self) -> dict:
        t = self.timer
        t.begin_iteration()
        self._steps += 1
        shadow = self.shadow_every > 0 \
            and self._steps % self.shadow_every == 0
        seen: Set[Signature] = set()
        samples: List[Tuple[str, float]] = []
        forced = 0
        cold_banked = 0
        for sig, thunk, freq in self.kernels:
            force = shadow and sig not in seen
            seen.add(sig)
            before = t._nexec
            charged = t.time_kernel(sig, thunk, freq, force=force)
            if t._nexec > before:       # really executed: charged == sample
                key = self._key(sig)
                samples.append((key, charged))
                if force:
                    forced += 1
                elif key in self.banked:
                    cold_banked += 1    # a banked kernel re-ran cold
        rep = t.report()
        return {"executed": rep.executed, "skipped": rep.skipped,
                "forced": forced, "cold_banked": cold_banked,
                "charged": rep.predicted_time, "samples": samples}


# ----------------------------------------------------------------- the daemon

class TuningDaemon:
    """The always-on tuning service: route -> warm-start -> serve ->
    drift -> re-tune (see the module docstring for the architecture)."""

    def __init__(self, provider, *, clock: Callable[[], float] = time.time,
                 config: Optional[DaemonConfig] = None,
                 fleet: Optional[FleetStore] = None,
                 checkpoint: Optional[str] = None,
                 executor_factory: Optional[Callable[[], Executor]] = None):
        self.provider = provider
        self.clock = clock
        self.cfg = config or DaemonConfig()
        self.checkpoint_path = checkpoint
        self.fleet = fleet if fleet is not None else FleetStore(
            clock=clock, half_life=self.cfg.half_life,
            ttl=self.cfg.evidence_ttl)
        self.drift = DriftDetector(
            self.fleet, z=self.cfg.drift_z,
            min_samples=self.cfg.drift_min_samples,
            window=self.cfg.drift_window)
        self.tuner = BackgroundTuner(
            executor_factory=executor_factory,
            max_retries=self.cfg.max_retries,
            retry_backoff=self.cfg.retry_backoff,
            on_event=self._scheduler_event,
            synchronous=self.cfg.synchronous)
        self._serve_policy = make_policy(
            self.cfg.serve_policy, tolerance=self.cfg.serve_tolerance,
            min_samples=self.cfg.serve_min_samples)
        self._lock = threading.RLock()
        #: shape key -> lifecycle state (TUNING/TUNED/RETUNING)
        self.state: Dict[str, str] = {}
        #: shape key -> installed winner {"name", "params", "predicted",
        #: "kernels": [structural keys]}
        self.winners: Dict[str, dict] = {}
        #: shape key -> the JSON-able meta route() was given
        self.meta: Dict[str, dict] = {}
        #: kernel structural key -> shape keys whose winner depends on it
        self.deps: Dict[str, Set[str]] = {}
        #: the event journal (every route/tune/drift/recovery event)
        self.events: List[dict] = []
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "warm_starts": 0, "cold_starts": 0,
            "retunes": 0, "drifts": 0, "forced": 0, "cold_banked_exec": 0}
        self._servers: Dict[str, _ShapeServer] = {}
        if checkpoint and os.path.exists(checkpoint):
            self._restore(DaemonCheckpoint.load(checkpoint))

    # -- journal -------------------------------------------------------------

    def _journal(self, event: str, **fields) -> None:
        with self._lock:
            entry = {"seq": len(self.events), "t": self.clock(),
                     "event": event}
            entry.update(fields)
            self.events.append(entry)

    def _scheduler_event(self, ev: dict) -> None:
        """Recovery events (retries, worker loss, deadlines) from the
        background scheduler, folded into the daemon journal."""
        self._journal("scheduler", **{k: v for k, v in ev.items()
                                      if k != "event"},
                      kind=ev.get("event"))

    # -- shape router --------------------------------------------------------

    def route(self, key: str, meta: dict) -> Tuple[str, Optional[dict]]:
        """Resolve a request shape: ``(state, winner-or-None)``.  A never-
        seen shape opens its study (returning ``("miss", None)``); a shape
        mid-study serves untuned; a tuned (or re-tuning) shape serves its
        installed winner."""
        with self._lock:
            st = self.state.get(key)
            if st in (TUNED, RETUNING):
                return st, self.winners[key]
            if st == TUNING:
                return TUNING, None
            self.counters["misses"] += 1
            self.meta[key] = dict(meta)
            self._open_study(key, tag="tune")
            return MISS, None

    def _open_study(self, key: str, *, tag: str) -> None:
        prior = self.fleet.prior()
        warm = len(prior) > 0
        if tag == "tune":
            self.counters["warm_starts" if warm else "cold_starts"] += 1
        session = self.provider.session_for(key, self.meta[key],
                                            prior if warm else None)
        self.state[key] = TUNING if tag == "tune" else RETUNING
        self._journal(f"{tag}_started", shape=key, warm=warm,
                      prior_entries=len(prior))
        self.tuner.submit(key, session, tag=tag)

    # -- study completion ----------------------------------------------------

    def pump(self) -> int:
        """Apply completed background studies: absorb harvests into the
        fleet store, atomically swap winners into the router, rebuild the
        dependency fan-out.  Returns how many results were applied.  Call
        from the serve loop (cheap when nothing completed)."""
        applied = 0
        for key, tag, result_json, err in self.tuner.drain():
            with self._lock:
                if err is not None:
                    self._journal("study_failed", shape=key, tag=tag,
                                  error=err.strip().splitlines()[-1])
                    # forget the in-flight state: the next request (or
                    # drift verdict) re-opens the study
                    if self.state.get(key) == TUNING:
                        self.state.pop(key, None)
                    elif self.state.get(key) == RETUNING:
                        self.state[key] = TUNED
                    continue
                self._apply(key, tag, StudyResult.from_json(result_json))
                applied += 1
        if applied and self.checkpoint_path:
            self.save_checkpoint()
        return applied

    def _apply(self, key: str, tag: str, result: StudyResult) -> None:
        rec = result.chosen
        old = self.winners.get(key)
        kernels = sorted(self.provider.kernel_keys(key, self.meta[key],
                                                   rec.name))
        self.fleet.absorb(result.stats_bank())
        self.winners[key] = {"name": rec.name, "params": rec.params,
                             "predicted": rec.predicted, "kernels": kernels}
        self.state[key] = TUNED
        for kk in kernels:
            self.deps.setdefault(kk, set()).add(key)
        self._servers.pop(key, None)   # rebind serving to the new winner
        if tag == "retune":
            self.counters["retunes"] += 1
        self._journal(f"{tag}_complete", shape=key, winner=rec.name,
                      previous=old["name"] if old else None,
                      executed=sum(r.executed for r in result.records),
                      skipped=sum(r.skipped for r in result.records))

    # -- serving -------------------------------------------------------------

    def serve(self, key: str, meta: dict) -> dict:
        """One serving step for a request shape: route it, and — when a
        winner is installed — run the winner's kernels through the
        shadow-mode selective timer, feeding forced samples to the drift
        detector and the fleet store."""
        state, winner = self.route(key, meta)
        info = {"shape": key, "state": state,
                "winner": winner["name"] if winner else None,
                "executed": 0, "skipped": 0, "forced": 0,
                "cold_banked": 0, "charged": 0.0}
        if winner is None:
            return info
        with self._lock:
            self.counters["hits"] += 1
            srv = self._servers.get(key)
            if srv is None:
                srv = self._servers[key] = _ShapeServer(
                    self.provider.kernels_for(key, self.meta[key],
                                              winner["name"]),
                    self._serve_policy, self.fleet.prior(), self.clock,
                    self.cfg.shadow_every)
        out = srv.step()
        samples = out.pop("samples")
        info.update(out)
        with self._lock:
            self.counters["forced"] += out["forced"]
            self.counters["cold_banked_exec"] += out["cold_banked"]
        for kkey, t in samples:
            self._observe(kkey, t)
        return info

    def _observe(self, kernel_key: str, t: float) -> None:
        """Fold one live kernel sample: drift verdict first (against the
        stored reference), then fleet accrual."""
        drifted = self.drift.observe(kernel_key, t)
        if not drifted:
            self.fleet.record(kernel_key, t)
            return
        with self._lock:
            self.counters["drifts"] += 1
            dependents = sorted(self.deps.get(kernel_key, ()))
            self._journal("drift_detected", kernel=kernel_key,
                          shapes=dependents)
            # stale evidence: the re-tune must measure this kernel fresh
            self.fleet.evict([kernel_key])
            for skey in dependents:
                # the stale-timed server must not keep charging old means
                self._servers.pop(skey, None)
                if self.state.get(skey) == TUNED:
                    self._open_study(skey, tag="retune")

    # -- checkpoint / restore ------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able daemon state: winners, fleet bank, journal, and the
        in-flight studies (resubmitted on restore)."""
        with self._lock:
            pending = [[k, "tune" if v == TUNING else "retune"]
                       for k, v in self.state.items()
                       if v in (TUNING, RETUNING)]
            return {"version": DAEMON_VERSION,
                    "winners": {k: dict(v) for k, v in self.winners.items()},
                    "meta": {k: dict(v) for k, v in self.meta.items()},
                    "pending": pending,
                    "bank": self.fleet.bank.to_json(),
                    "events": list(self.events),
                    "counters": dict(self.counters)}

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        path = path or self.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured")
        DaemonCheckpoint.save(path, self.snapshot())

    def _restore(self, data: dict) -> None:
        self.fleet.bank = StatisticsBank.from_json(data["bank"])
        self.winners = {k: dict(v) for k, v in data["winners"].items()}
        self.meta = {k: dict(v) for k, v in data.get("meta", {}).items()}
        self.events = list(data.get("events", []))
        self.counters.update(data.get("counters", {}))
        for k, w in self.winners.items():
            self.state[k] = TUNED
            for kk in w.get("kernels", ()):
                self.deps.setdefault(kk, set()).add(k)
        self._journal("restored", winners=len(self.winners),
                      bank_entries=len(self.fleet.bank),
                      pending=len(data.get("pending", ())))
        # studies that were in flight at the kill are resubmitted; their
        # warm-start prior is rebuilt from the restored fleet bank
        for k, tag in data.get("pending", ()):
            if k in self.meta and self.state.get(k) != TUNING:
                if tag == "retune" and k in self.winners:
                    self._open_study(k, tag="retune")
                elif k not in self.winners:
                    self._open_study(k, tag="tune")

    # -- lifecycle -----------------------------------------------------------

    def ratios(self) -> Dict[str, float]:
        """Hit/miss summary for dashboards and the CI smoke stage."""
        c = self.counters
        total = c["hits"] + c["misses"]
        opened = c["warm_starts"] + c["cold_starts"]
        return {"hit_ratio": c["hits"] / total if total else 0.0,
                "warm_start_ratio":
                    c["warm_starts"] / opened if opened else 0.0,
                **{k: float(v) for k, v in c.items()}}

    def close(self, *, checkpoint: bool = True) -> None:
        self.tuner.close()
        self.pump()
        if checkpoint and self.checkpoint_path:
            self.save_checkpoint()
