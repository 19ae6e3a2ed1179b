"""Always-on tuning for the LM serving stack: the daemon's LM binding
(port of ``repro.serve.tuner``).

``repro_torch.api.daemon`` (a verbatim copy of ``repro.api.daemon``)
supplies the generic service (shape router, fleet profile store, drift
detector, background re-tunes); this module binds it to the port's LM
step-knob studies:

- request shapes are ``(arch, batch, bucketed seqlen)`` — the sequence
  bucket comes from ``repro_torch.serve.engine.bucket_length``, the SAME
  function the engine pads prompts with, so the daemon tunes exactly the
  shapes the engine runs;
- shape keys live in the world-independent structural-key namespace
  (``shape_key``), the identity space the statistics bank already uses;
- a shape's study is the port's ``LMStudy.session`` over ``StepKnobs``,
  warm-started from the fleet store; each of its kernels is a
  forward+backward through the port's CUDA kernels on the card.

Lifecycle::

    route -> warm-start -> serve -> drift -> re-tune

``ServingTuner`` is the engine-side facade (``serve_step`` /
``knobs_for``); ``run_daemon_demo`` drives simulated traffic through a
daemon.  Studies run on the card unless the provider is given
``device="cpu"``; ``reduced=False`` tunes the published widths (the JAX
binding always tunes the reduced configuration).  Background studies run
on a thread of this process (the daemon's default ``InProcessExecutor``):
a process forked after CUDA is initialised cannot use the card, so the
fork executor is for CPU studies only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.signatures import comp_sig, structural_key
from repro_torch.api.daemon import (DaemonConfig, FleetStore, TuningDaemon,
                                    TUNED, RETUNING)
from repro_torch.device import DeviceLike
from .engine import bucket_length


def shape_key(arch: str, batch: int, seq: int) -> str:
    """Study key of one (arch, batch, bucketed-seqlen) request shape, in
    the same world-independent structural-key namespace the statistics
    bank uses."""
    return structural_key(comp_sig("lm_shape", arch, int(batch), int(seq)),
                          1)


class VirtualClock:
    """Deterministic tick clock: every reading advances time by ``dt``,
    so a timed region spanning one thunk always measures exactly ``dt``.
    Simulated-traffic runs give each thread (serve loop, background
    tuner) its own instance; scaling ``dt`` mid-run injects a kernel-cost
    shift for drift-detection drills."""

    def __init__(self, dt: float = 1e-3):
        self.dt = dt
        self.now = 0.0

    def __call__(self) -> float:
        self.now += self.dt
        return self.now


class LMShapeProvider:
    """``TuningDaemon`` provider over per-shape ``LMStudy`` instances.

    Studies are cached per (arch, batch, seq) so serving reuses the
    study's kernel closures; ``clock`` (optional) pins study timing to a
    deterministic source.  The fleet prior is handed to
    ``LMStudy.session`` undiscounted (``prior_discount=1.0``) — the fleet
    store's age decay is the trust mechanism.  ``device`` and ``reduced``
    go to each ``LMStudy`` (``None``: the card)."""

    def __init__(self, *, policy: str = "eager", tolerance: float = 0.25,
                 trials: int = 2, max_configs: Optional[int] = None,
                 seed: int = 0, clock=None, prior_discount: float = 1.0,
                 prior_max_cv: Optional[float] = None,
                 device: DeviceLike = None, reduced: bool = True):
        self.policy = policy
        self.tolerance = tolerance
        self.trials = trials
        self.max_configs = max_configs
        self.seed = seed
        self.clock = clock
        self.prior_discount = prior_discount
        self.prior_max_cv = prior_max_cv
        self.device = device
        self.reduced = reduced
        self._studies: Dict[Tuple[str, int, int], object] = {}

    def study(self, meta: dict):
        skey = (meta["arch"], int(meta["batch"]), int(meta["seq"]))
        st = self._studies.get(skey)
        if st is None:
            from repro_torch.tune.lm_study import LMStudy
            st = self._studies[skey] = LMStudy(
                skey[0], batch=skey[1], seq=skey[2], seed=self.seed,
                device=self.device, reduced=self.reduced)
        return st

    def point_for(self, meta: dict, name: str):
        for pt in self.study(meta).search_space(self.max_configs).points:
            if pt.name == name:
                return pt
        raise KeyError(f"no StepKnobs configuration named {name!r}")

    # -- TuningDaemon provider protocol --------------------------------------

    def session_for(self, key: str, meta: dict, prior):
        return self.study(meta).session(
            policy=self.policy, tolerance=self.tolerance,
            trials=self.trials, max_configs=self.max_configs,
            prior=prior, prior_discount=self.prior_discount,
            prior_max_cv=self.prior_max_cv, collect_stats=True,
            clock=self.clock, seed=self.seed)

    def kernels_for(self, key: str, meta: dict, winner_name: str):
        return self.study(meta).kernels_of(self.point_for(meta,
                                                          winner_name))

    def kernel_keys(self, key: str, meta: dict,
                    winner_name: str) -> List[str]:
        knobs = self.point_for(meta, winner_name).payload
        return sorted({structural_key(sig, 1) for sig, _, _
                       in self.study(meta).kernel_sequence(knobs)})


class ServingTuner:
    """The engine-side facade: route live (batch, seqlen) traffic into
    the always-on tuning daemon.

    ``serve_step`` runs one serving step for a request shape (pumping
    completed background studies first, so freshly landed winners swap in
    before routing); ``knobs_for`` resolves the shape's tuned
    ``StepKnobs`` (or None while the first study is still in flight) for
    the engine to apply."""

    def __init__(self, arch: str, *,
                 seq_buckets: Sequence[int] = (16, 32, 64, 128),
                 provider: Optional[LMShapeProvider] = None,
                 clock=time.time, config: Optional[DaemonConfig] = None,
                 fleet: Optional[FleetStore] = None,
                 checkpoint: Optional[str] = None,
                 executor_factory=None, **provider_kw):
        self.arch = arch
        self.seq_buckets = tuple(seq_buckets)
        self.provider = provider if provider is not None \
            else LMShapeProvider(**provider_kw)
        self.daemon = TuningDaemon(
            self.provider, clock=clock, config=config, fleet=fleet,
            checkpoint=checkpoint, executor_factory=executor_factory)

    def shape_of(self, batch: int, seqlen: int) -> Tuple[str, dict]:
        seq = bucket_length(int(seqlen), self.seq_buckets)
        meta = {"arch": self.arch, "batch": int(batch), "seq": seq}
        return shape_key(self.arch, batch, seq), meta

    def serve_step(self, batch: int, seqlen: int) -> dict:
        self.daemon.pump()
        key, meta = self.shape_of(batch, seqlen)
        return self.daemon.serve(key, meta)

    def knobs_for(self, batch: int, seqlen: int):
        key, meta = self.shape_of(batch, seqlen)
        winner = self.daemon.winners.get(key)
        if winner is None:
            return None
        return self.provider.point_for(meta, winner["name"]).payload

    def close(self, *, checkpoint: bool = True) -> None:
        self.daemon.close(checkpoint=checkpoint)


# ------------------------------------------------------- simulated traffic

def _pump_until(daemon: TuningDaemon, keys, *, timeout: float = 300.0,
                poll: float = 0.02) -> bool:
    """Pump until every key reaches TUNED (or the wait times out)."""
    deadline = time.monotonic() + timeout
    while True:
        daemon.pump()
        if all(daemon.state.get(k) == TUNED for k in keys):
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(poll)


def run_daemon_demo(arch: str = "smollm-135m", *,
                    shapes: Sequence[Tuple[int, int]] = ((2, 16), (2, 24),
                                                         (4, 16)),
                    seq_buckets: Sequence[int] = (16, 32),
                    rounds: int = 4, max_configs: int = 3, trials: int = 2,
                    shadow_every: int = 3, drift_scale: float = 5.0,
                    drift_rounds: int = 10, checkpoint: Optional[str] = None,
                    bank_path: Optional[str] = None,
                    synchronous: bool = False, dt: float = 1e-3,
                    log=None, device: DeviceLike = None,
                    reduced: bool = True) -> dict:
    """Simulated live traffic through an always-on tuning daemon.

    Three phases over ``shapes`` (each a (batch, seqlen) pair) against
    the ``arch`` config (reduced unless ``reduced=False``) on ``device``
    (``None``: the card), on deterministic virtual clocks (one per
    thread, so background studies and the serve loop never perturb each
    other's timings):

    1. every shape's first occurrence opens a (fleet-warm-started) study
       in the background; the loop keeps serving until winners land;
    2. steady-state serving: tuned shapes run the winner's kernels
       through the shadow-mode selective timer — banked signatures
       execute zero times outside forced shadow samples;
    3. a kernel-cost shift (both clocks' ``dt`` scaled by
       ``drift_scale``) trips the drift detector; affected shapes
       re-tune in the background while the loop keeps serving, and the
       recovery lands in the daemon's event journal.

    Returns a JSON-able summary (counters, hit/miss ratios, per-phase
    serve infos, the journal).
    """
    say = log or (lambda *a: None)
    serve_clock = VirtualClock(dt)
    study_clock = VirtualClock(dt)
    provider = LMShapeProvider(trials=trials, max_configs=max_configs,
                               clock=study_clock, device=device,
                               reduced=reduced)
    cfg = DaemonConfig(shadow_every=shadow_every, drift_z=3.0,
                       drift_min_samples=2, serve_min_samples=2,
                       synchronous=synchronous)
    tuner = ServingTuner(arch, seq_buckets=seq_buckets, provider=provider,
                         clock=serve_clock, config=cfg,
                         checkpoint=checkpoint)
    daemon = tuner.daemon
    keys = [tuner.shape_of(b, s)[0] for b, s in shapes]

    say(f"phase 1: routing {len(shapes)} shapes (studies open in "
        f"background)")
    for b, s in shapes:
        info = tuner.serve_step(b, s)
        say(f"  shape batch={b} seq={s}: {info['state']}")
        # let each study land before the next shape arrives, so later
        # shapes warm-start from the fleet knowledge earlier ones banked
        if not _pump_until(daemon, [tuner.shape_of(b, s)[0]]):
            raise RuntimeError(f"study for shape {(b, s)} did not land")

    say("phase 2: steady-state serving")
    tuned_serves: Dict[str, List[dict]] = {k: [] for k in keys}
    for _ in range(max(rounds, 2)):
        for b, s in shapes:
            info = tuner.serve_step(b, s)
            if info["winner"] is not None:
                tuned_serves[info["shape"]].append(
                    {k: info[k] for k in ("state", "winner", "executed",
                                          "forced", "cold_banked")})

    # snapshot before the drift drill: steady-state serving must re-run
    # zero banked kernels cold (drift *recovery* legitimately re-executes
    # banked kernels whose evidence went stale)
    steady = dict(daemon.counters)

    drifted = False
    served_while_retuning = 0
    if drift_scale and drift_scale != 1.0:
        say(f"phase 3: injecting {drift_scale}x kernel-cost shift")
        serve_clock.dt *= drift_scale
        study_clock.dt *= drift_scale
        for _ in range(drift_rounds):
            for b, s in shapes:
                info = tuner.serve_step(b, s)
                if info["state"] == RETUNING:
                    served_while_retuning += 1
            daemon.pump()
        drifted = daemon.counters["drifts"] > 0
        if not _pump_until(daemon, keys):
            raise RuntimeError("re-tunes did not settle")

    daemon.pump()
    second = {k: (v[1] if len(v) > 1 else None)
              for k, v in tuned_serves.items()}
    summary = {
        "arch": arch, "shapes": len(shapes),
        "counters": dict(daemon.counters),
        "steady_state_counters": steady,
        "ratios": daemon.ratios(),
        "second_tuned_serves": second,
        "served_while_retuning": served_while_retuning,
        "drift_detected": drifted,
        "retunes": daemon.counters["retunes"],
        "events": list(daemon.events),
    }
    if bank_path:
        daemon.fleet.save(bank_path)
        summary["bank_path"] = bank_path
        summary["bank_entries"] = len(daemon.fleet)
    tuner.close(checkpoint=checkpoint is not None)
    say(f"done: {summary['counters']}")
    return summary
