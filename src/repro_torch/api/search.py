"""Search drivers over a backend run (lifted out of ``core.tuner``).

``exhaustive`` is the paper's evaluation protocol (§VI.A): for each
configuration, one full reference execution, the policy's optional charged
offline pass, then ``trials`` selective executions; statistics reset
between configurations per the space's protocol switch.

``racing`` is the beyond-paper successive-elimination search driven by the
paper's own confidence intervals: each round gives every surviving
configuration one selective trial and prunes a configuration once the
lower CI bound of its predicted time exceeds the incumbent's upper bound.

``model_guided`` never visits most of the grid at all: it fits a
Gaussian-copula candidate model over recorded statistics banks
(``transfer.CopulaModel``), scores every point through its RNG-free
structural profile (``BackendRun.kernel_profile``) under seeded joint
kernel-time draws, prefilters the top-scored candidates with analytic
roofline lower bounds against an optional measured incumbent
(``BackendRun.cost_lower_bound``), and hands the survivors to ``racing``
for statistical-confidence arbitration — paper-geometry sweeps touching
<10% of the grid with the same winners.

All produce the uniform ``ConfigRecord``/``StudyResult`` rows; the
``Autotuner`` shim in ``core.tuner`` delegates here, so the sim goldens
pin these drivers bit-for-bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policies import Policy
from repro_torch.core.stats import t_quantile_975

from .result import ConfigRecord
from .space import ConfigPoint, SearchSpace

# NOTE: this module deliberately does not import .backends (the run is
# duck-typed) — core.tuner imports these drivers at module level, and a
# .backends dependency would close an import cycle through repro.core.

SEARCHES = ("exhaustive", "racing", "model_guided")


def measure_config(run: "BackendRun", point: ConfigPoint, policy: Policy, *,
                   trials: int = 3) -> ConfigRecord:
    """The paper's per-configuration measurement sequence."""
    ref = run.run_reference(point)
    full_time = ref.time

    selective_cost = 0.0
    if policy.needs_offline_pass:
        off = run.run_offline(point)
        selective_cost += off.cost

    predictions: List[float] = []
    last = ref
    for _ in range(trials):
        last = run.run_trial(point)
        selective_cost += last.cost
        predictions.append(last.predicted)

    predicted = predictions[-1]
    rel_error = (abs(predicted - full_time) / full_time
                 if full_time > 0 else 0.0)
    comp_error = (abs(last.comp - ref.comp) / ref.comp
                  if ref.comp > 0 else 0.0)
    extra = dict(ref.extra)
    extra.update(last.extra)
    return ConfigRecord(
        name=point.name, params=point.params, full_time=full_time,
        predicted=predicted, rel_error=rel_error, comp_error=comp_error,
        selective_cost=selective_cost, full_cost=full_time * trials,
        executed=last.executed, skipped=last.skipped,
        predictions=predictions, extra=extra)


def exhaustive(run: "BackendRun", space: SearchSpace, policy: Policy, *,
               trials: int = 3,
               start_records: Optional[List[ConfigRecord]] = None,
               on_record: Optional[Callable[[ConfigRecord], None]] = None,
               ) -> Tuple[List[ConfigRecord], dict]:
    """Measure every point in order.  ``start_records`` resumes a
    checkpointed study: the first ``len(start_records)`` points are taken
    as done (valid because resumption is only offered when statistics
    reset between configurations, so a fresh backend run at point k is in
    the same state as one that measured points 0..k-1 and reset)."""
    records = list(start_records or ())
    reset = space.should_reset(policy)
    for i, point in enumerate(space.points):
        if i < len(records):
            continue
        if i > 0 and reset:
            run.reset_models()
        rec = measure_config(run, point, policy, trials=trials)
        records.append(rec)
        if on_record is not None:
            on_record(rec)
    return records, {}


def racing(run: "BackendRun", space: SearchSpace, policy: Policy, *,
           max_rounds: int = 6, min_survivor_trials: int = 2,
           trials: int = 1) -> Tuple[List[ConfigRecord], dict]:
    """Successive elimination driven by the paper's CIs.

    The per-kernel statistical machinery is reused verbatim — racing only
    changes *which* configurations keep getting iterations, exactly the
    composition the paper suggests with search-space pruning studies.
    Models are never reset (racing interleaves configurations; resetting
    would discard everything each step).

    Returns one record per configuration: ``predictions`` holds the
    config's per-round selective samples, ``predicted`` their mean, and
    ``extra`` carries the racing artifacts (round pruned, survivor set).
    ``trials`` is accepted for driver-signature uniformity and ignored
    (each round is one trial per survivor).
    """
    points = list(space.points)
    samples: Dict[str, List[float]] = {p.name: [] for p in points}
    costs: Dict[str, float] = {p.name: 0.0 for p in points}
    counts: Dict[str, Tuple[int, int]] = {p.name: (0, 0) for p in points}
    active = {p.name for p in points}
    pruned_at: Dict[str, int] = {}
    cost = 0.0

    def ci(name: str) -> Tuple[float, float]:
        xs = samples[name]
        n = len(xs)
        m = float(np.mean(xs))
        if n < 2:
            return m, math.inf
        hw = t_quantile_975(n - 1) * float(np.std(xs, ddof=1)) \
            / math.sqrt(n)
        return m, hw

    rounds = 0
    for rnd in range(max_rounds):
        rounds = rnd + 1
        for p in points:
            if p.name not in active:
                continue
            m = run.run_trial(p)
            cost += m.cost
            costs[p.name] += m.cost
            counts[p.name] = (m.executed, m.skipped)
            samples[p.name].append(m.predicted)
        stats = {nm: ci(nm) for nm in active}
        inc = min(stats, key=lambda nm: stats[nm][0])
        inc_hi = stats[inc][0] + stats[inc][1]
        for nm in list(active):
            if nm == inc:
                continue
            m, hw = stats[nm]
            if len(samples[nm]) >= min_survivor_trials and m - hw > inc_hi:
                active.remove(nm)
                pruned_at[nm] = rnd
        if len(active) == 1:
            break

    best = min(active, key=lambda nm: float(np.mean(samples[nm])))
    records = []
    for p in points:
        xs = samples[p.name]
        ex, sk = counts[p.name]
        records.append(ConfigRecord(
            name=p.name, params=p.params, full_time=0.0,
            predicted=float(np.mean(xs)) if xs else math.inf,
            rel_error=0.0, comp_error=0.0,
            selective_cost=costs[p.name], full_cost=0.0,
            executed=ex, skipped=sk, predictions=list(xs),
            extra={"pruned_at": pruned_at.get(p.name)}))
    extra = {"best": best, "survivors": sorted(active),
             "pruned_at": pruned_at, "rounds": rounds,
             "total_iterations": sum(len(v) for v in samples.values()),
             "cost": cost}
    return records, extra


# ------------------------------------------------------------- model-guided

def normalize_options(search: str, options: dict) -> dict:
    """JSON-normalize driver options at session construction so scheduler
    task payloads ship them verbatim (``StatisticsBank`` / ``CopulaModel``
    objects become their ``to_json`` payloads — a forked or remote worker
    reconstructs the identical model)."""
    if search != "model_guided":
        return options
    out = dict(options)
    banks = out.get("banks")
    if banks:
        out["banks"] = [b if isinstance(b, dict) else b.to_json()
                        for b in banks]
    model = out.get("model")
    if model is not None and not isinstance(model, dict):
        out["model"] = model.to_json()
    return out


def _coverage_budget(n_points: int, max_coverage: float) -> int:
    """Largest candidate count strictly under ``max_coverage`` of the
    grid, floored at one (some candidate must always be dispatched)."""
    k = int(n_points * max_coverage + 1e-9)
    if k >= n_points * max_coverage - 1e-9:
        k -= 1
    return max(1, k)


def _incumbent_upper(incumbent) -> Optional[float]:
    """Resolve an incumbent spec to its upper confidence bound: a float,
    ``{"upper": t}``, or ``{"mean": m, "halfwidth": h}``.  ``None`` (or an
    empty dict) means no incumbent — the prefilter passes everything."""
    if incumbent is None:
        return None
    if isinstance(incumbent, (int, float)):
        return float(incumbent)
    if "upper" in incumbent:
        return float(incumbent["upper"])
    if "mean" in incumbent:
        return float(incumbent["mean"]) \
            + float(incumbent.get("halfwidth", 0.0))
    return None


def _surrogate_scores(run: "BackendRun", points: List[ConfigPoint], model,
                      rng, n_samples: int) -> Optional[List[float]]:
    """Per-point critical-path surrogate under the copula model: for each
    of ``n_samples`` joint kernel-time draws, charge every occurrence its
    drawn time on each participating rank (the backend's structural
    profile) and take the slowest rank; the score is the mean over draws.
    ``None`` when the backend cannot profile or the model covers no
    profiled kernel — the driver then samples candidates uniformly.

    Profiling the full grid goes through the backend's compiled-program
    map (and its ``ProgramCache`` when one is configured — see
    ``repro.simmpi.program``), so scoring records each unique geometry at
    most once, survivors' measurements reuse the scorer's programs, and a
    warm cache makes grid scoring recording-free entirely."""
    if not model:
        return None
    profiles = []
    for p in points:
        prof = run.kernel_profile(p)
        if prof is None:
            return None
        profiles.append(prof)
    index = {k: j for j, k in enumerate(model.keys)}
    draws = model.sample(n_samples, rng).T          # (keys, samples)
    scores: List[float] = []
    overlap = 0
    for prof in profiles:
        counts = None
        for key, per_rank in prof.items():
            j = index.get(key)
            if j is None:
                continue                # kernel unknown to the model
            overlap += 1
            if counts is None:
                counts = np.zeros((len(per_rank), len(model.keys)))
            counts[:, j] += per_rank
        if counts is None:
            scores.append(math.inf)     # nothing modeled: rank last
            continue
        per_rank_draws = counts @ draws             # (ranks, samples)
        scores.append(float(per_rank_draws.max(axis=0).mean()))
    return scores if overlap else None


def model_guided(run: "BackendRun", space: SearchSpace, policy: Policy, *,
                 trials: int = 1, banks: Optional[list] = None,
                 model=None, seed: int = 0, n_samples: int = 64,
                 max_coverage: float = 0.10, top_k: Optional[int] = None,
                 incumbent=None, max_rounds: int = 6,
                 min_survivor_trials: int = 2,
                 start_state: Optional[dict] = None,
                 on_state: Optional[Callable[[dict], None]] = None,
                 ) -> Tuple[List[ConfigRecord], dict]:
    """Copula-sampled, roofline-pruned candidate search.

    Three stages: (1) fit a ``transfer.CopulaModel`` over ``banks`` (or
    use a pre-fitted ``model``) and score every grid point by the mean
    critical-path surrogate over ``n_samples`` seeded joint draws, keeping
    the best ``top_k`` (default: the largest count strictly under
    ``max_coverage`` of the grid); (2) drop candidates whose analytic
    roofline lower bound (``run.cost_lower_bound``) provably exceeds the
    ``incumbent``'s measured upper CI bound — they are never dispatched;
    (3) let ``racing`` arbitrate the survivors with statistical
    confidence.  Unvisited points keep a record with ``predicted = inf``
    and no samples, so results stay shape-uniform with the other drivers.

    Selection is deterministic from ``seed`` and the space's pinned
    enumeration order, and the post-selection sampler RNG state is
    journaled through ``on_state`` / replayed via ``start_state``
    (alongside the survivor set and the space's ``order_fingerprint``,
    which resume validates), so a killed-and-resumed or fork-dispatched
    study is bit-identical to the serial driver.

    Degenerate models (empty/unmatched banks, a backend without profiles)
    fall back to uniform candidate sampling under the same seed —
    coverage still holds; only the guidance is lost.
    """
    from .transfer import CopulaModel, StatisticsBank

    points = list(space.points)
    n_points = len(points)
    order = space.order_fingerprint()
    rng = np.random.default_rng(seed)

    if start_state is not None:
        if start_state.get("space_order") != order:
            raise ValueError(
                "checkpointed model-guided selection was sampled over a "
                f"different point enumeration ({start_state.get('space_order')!r}"
                f" != {order!r}); refusing to resume")
        sel = dict(start_state)
        rng.bit_generator.state = sel["rng"]
    else:
        if model is not None and not isinstance(model, CopulaModel):
            model = CopulaModel.from_json(model)
        if model is None:
            model = CopulaModel.fit(
                [b if isinstance(b, StatisticsBank)
                 else StatisticsBank.from_json(b) for b in (banks or [])])
        k = _coverage_budget(n_points, max_coverage) if top_k is None \
            else max(1, min(top_k, n_points))
        scores = _surrogate_scores(run, points, model, rng, n_samples)
        if scores is None:
            ranked = [int(i) for i in rng.permutation(n_points)]
            fallback = "uniform"
        else:
            ranked = sorted(range(n_points),
                            key=lambda i: (scores[i], i))
            fallback = None
        candidates = [points[i].name for i in ranked[:k]]
        pruned: List[str] = []
        upper = _incumbent_upper(incumbent)
        if upper is not None:
            by_name = {p.name: p for p in points}
            kept = []
            for nm in candidates:
                lb = run.cost_lower_bound(by_name[nm])
                if lb is not None and lb > upper:
                    pruned.append(nm)
                else:
                    kept.append(nm)
            candidates = kept
        sel = {"space_order": order, "survivors": candidates,
               "roofline_pruned": pruned, "fallback": fallback,
               "rho": model.rho, "model_keys": len(model),
               "rng": rng.bit_generator.state}
        if on_state is not None:
            on_state(sel)

    chosen = set(sel["survivors"])
    surv = [p for p in points if p.name in chosen]
    if surv:
        sub = SearchSpace(name=space.name, points=surv,
                          reset_between_configs=space.reset_between_configs,
                          world_size=space.world_size,
                          machine=space.machine)
        sub_records, race = racing(
            run, sub, policy, max_rounds=max_rounds,
            min_survivor_trials=min_survivor_trials, trials=trials)
    else:
        # every candidate was provably dominated by the incumbent: nothing
        # to measure, and nothing here beats what the caller already has
        sub_records, race = [], {
            "best": None, "survivors": [], "pruned_at": {}, "rounds": 0,
            "total_iterations": 0, "cost": 0.0}
    by = {r.name: r for r in sub_records}
    pruned_set = set(sel["roofline_pruned"])
    records: List[ConfigRecord] = []
    for p in points:
        rec = by.get(p.name)
        if rec is None:
            rec = ConfigRecord(
                name=p.name, params=p.params, full_time=0.0,
                predicted=math.inf, rel_error=0.0, comp_error=0.0,
                selective_cost=0.0, full_cost=0.0, executed=0, skipped=0,
                predictions=[],
                extra={"selected": False,
                       "roofline_pruned": p.name in pruned_set})
        records.append(rec)
    extra = {"best": race["best"], "survivors": race["survivors"],
             "pruned_at": race["pruned_at"], "rounds": race["rounds"],
             "total_iterations": race["total_iterations"],
             "cost": race["cost"],
             "dispatched": [p.name for p in surv],
             "coverage": len(surv) / n_points if n_points else 0.0,
             "roofline_pruned": list(sel["roofline_pruned"]),
             "fallback": sel["fallback"],
             "sampler": {"seed": seed, "n_samples": n_samples,
                         "rho": sel["rho"],
                         "model_keys": sel["model_keys"],
                         "space_order": order}}
    return records, extra
