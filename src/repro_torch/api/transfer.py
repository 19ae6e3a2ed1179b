"""Cross-study statistics transfer: warm-started sessions.

The paper's entire speed-up comes from per-kernel statistical profiles
crossing the predictability threshold; a fresh ``AutotuneSession`` rebuilds
every profile from zero even when a prior study on a neighboring problem
size, tolerance, or policy already measured the same kernel signatures.
This module closes that loop:

1. a completed study exports its per-kernel ``KernelStats`` posteriors
   (``AutotuneSession(..., collect_stats=True)`` attaches them to
   ``StudyResult.extra["kernel_stats"]``);
2. a ``StatisticsBank`` holds those posteriors keyed by *structural
   signature keys* (``core.signatures.structural_key``) — world-independent
   identities, so a bank recorded at one processor count matches
   signatures interned by a different world;
3. ``AutotuneSession(..., prior=bank)`` seeds the backend's statistical
   state so already-confident kernels start in the skip regime: eager
   sessions switch them off machine-wide outright, once-per-iteration
   policies skip every occurrence after the mandatory first execution —
   from trial one instead of after ``min_samples`` rebuild executions.

Trust control:

- ``bank.discounted(f)`` (applied by the session's ``prior_discount``)
  keeps each transferred mean/variance but carries only ``f`` of the
  evidence, widening the CI so stale banks re-earn confidence;
- ``bank.remapped(target)`` is a Gaussian-copula-style quantile remap
  between the source and target sample distributions (the
  transfer-learning direction of Randall et al.): a monotone CDF map with
  Gaussian marginals reduces to the z-score affine map, so kernels
  measured in BOTH banks adopt the target's marginal while pooling both
  banks' evidence, and source-only kernels are rescaled through a global
  log-space fit of the matched pairs — transferring across machines or
  allocations whose timings differ by a systematic factor.

Banks merge (``StatisticsBank.merge``), round-trip losslessly through
JSON (``to_json``/``from_json``, ``save``/``load``), and fingerprint into
session checkpoint keys so warm results are never replayed as cold ones.

``CopulaModel`` turns the same quantile machinery generative: per-kernel
Gaussian marginals fitted over one or more banks, joined by an empirical
equicorrelation structure (the one-factor Gaussian copula), with a seeded
``sample(n, rng)`` — the candidate model behind the ``model_guided``
search driver (``repro.api.search``).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.signatures import Signature, structural_key
from repro_torch.core.stats import KernelStats

from .serialize import dumps_canonical

BANK_VERSION = 1
COPULA_VERSION = 1


class Harvest:
    """Accumulates a backend run's measured kernel statistics into bank
    form, across model resets, without re-banking a seeded prior.

    ``add`` folds a pooled per-signature table in (two signatures may
    share one structural key — e.g. two sub-communicators of the same
    relative shape — and Chan-merge).  When the run was warm-started, each
    seeded kernel's table entry is ``merge(prior, new samples)``; ``add``
    strips the prior via ``KernelStats.minus`` so that repeated harvests
    (one per reset) bank only the *measured* evidence — the prior itself
    re-enters the exported payload exactly once, keeping chained
    warm-starts from compounding transferred confidence.  (Under eager
    cross-rank aggregation the subtraction is approximate: merged tables
    carry one prior copy per participant, matching eager's per-rank
    counting of real samples.)
    """

    def __init__(self, world_size: int, prior: "StatisticsBank" = None):
        self.world_size = world_size
        self._prior = prior.entries if prior else {}
        self._acc: Dict[str, KernelStats] = {}

    def add(self, pooled: Dict[Signature, KernelStats],
            into: Optional[Dict[str, KernelStats]] = None) -> None:
        acc = self._acc if into is None else into
        for sig, st in pooled.items():
            if st.n == 0:
                continue
            key = structural_key(sig, self.world_size)
            p = self._prior.get(key)
            if p is not None:
                st = st.minus(p)
                if st is None:         # nothing beyond the seeded prior
                    continue
            got = acc.get(key)
            if got is None:
                acc[key] = st.copy()
            else:
                got.merge(st)

    def payload(self, pooled_now: Dict[Signature, KernelStats]) -> dict:
        """Bank JSON of everything harvested so far plus the live table,
        with the seeded prior folded back in once."""
        out = {k: v.copy() for k, v in self._acc.items()}
        self.add(pooled_now, into=out)
        for key, p in self._prior.items():
            got = out.get(key)
            if got is None:
                out[key] = p.copy()
            else:
                got.merge(p)
        return StatisticsBank(out).to_json()


class StatisticsBank:
    """Per-kernel ``KernelStats`` posteriors keyed by structural keys."""

    def __init__(self, entries: Optional[Dict[str, KernelStats]] = None,
                 *, meta: Optional[List[dict]] = None):
        self.entries: Dict[str, KernelStats] = dict(entries or {})
        #: provenance rows ({study, policy, tolerance, world_size, ...});
        #: informational only — never consulted by matching
        self.meta: List[dict] = list(meta or [])

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:        # an empty bank is a no-op prior
        return bool(self.entries)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_result(cls, result) -> "StatisticsBank":
        """Extract the bank a ``collect_stats=True`` session attached to a
        ``StudyResult`` (raises KeyError when the study did not collect)."""
        payload = result.extra["kernel_stats"]
        bank = cls.from_json(payload)
        if not bank.meta:
            bank.meta = [{"study": result.study, "policy": result.policy,
                          "tolerance": result.tolerance,
                          "backend": result.backend}]
        return bank

    def merge(self, other: "StatisticsBank") -> "StatisticsBank":
        """Key-wise Chan-merged union of two banks (new bank; sources
        untouched).  Structural keys are world-independent, so banks from
        different machine geometries merge directly."""
        out: Dict[str, KernelStats] = {k: v.copy()
                                       for k, v in self.entries.items()}
        for k, st in other.entries.items():
            acc = out.get(k)
            if acc is None:
                out[k] = st.copy()
            else:
                acc.merge(st)
        return StatisticsBank(out, meta=self.meta + other.meta)

    def discounted(self, factor: float) -> "StatisticsBank":
        """Evidence-discounted copy (see ``KernelStats.discounted``);
        entries whose discounted sample count reaches zero are dropped."""
        if factor >= 1.0:
            return self
        out = {}
        for k, st in self.entries.items():
            d = st.discounted(factor)
            if d.n > 0:
                out[k] = d
        return StatisticsBank(
            out, meta=self.meta + [{"discount": factor}])

    # -- evidence age (fleet-store support) ----------------------------------

    def stamp(self, now: float, *, only_unstamped: bool = True) -> None:
        """Stamp entries with ``now`` as their evidence time (in place).
        By default only unstamped entries are touched, so merging a freshly
        harvested bank then stamping records *when the fleet learned it*
        without rejuvenating older evidence."""
        for st in self.entries.values():
            if st.last_updated is None or not only_unstamped:
                st.last_updated = now

    def discount_by_age(self, now: float, half_life: float, *,
                        ttl: Optional[float] = None) -> "StatisticsBank":
        """Wall-clock decay view of the bank (new bank; source untouched):
        each stamped entry keeps its mean/variance but halves its evidence
        every ``half_life`` seconds of age (``KernelStats.discount_by_age``),
        and entries older than ``ttl`` seconds — or decayed to zero samples
        — are dropped outright.  Unstamped entries never age."""
        out: Dict[str, KernelStats] = {}
        for k, st in self.entries.items():
            if ttl is not None and st.last_updated is not None \
                    and now - st.last_updated > ttl:
                continue
            d = st.discount_by_age(now, half_life)
            if d.n > 0:
                out[k] = d
        return StatisticsBank(
            out, meta=self.meta + [{"age_discount": {
                "now": now, "half_life": half_life, "ttl": ttl}}])

    def filtered(self, *, max_cv: float,
                 min_samples: int = 2) -> "StatisticsBank":
        """Per-key quality filter: drop entries whose coefficient of
        variation (std / mean) exceeds ``max_cv``.

        Structural keys deliberately coarsen kernel identity — byte
        bucketing pools nearby message sizes, world-relative geometry pools
        sub-grids — so a bank recorded across several configurations can
        hold *mixture* distributions: high-dispersion entries whose wide CI
        never crosses the predictability threshold, yet whose seeded
        presence delays the target study's own (much tighter) per-config
        statistics from doing so (``KernelStats.merge`` pools the prior
        with the fresh samples).  Dropping them lets those kernels start
        cold and converge fast, while low-dispersion entries — the ones
        transfer actually pays off for — seed as usual.  Entries with
        fewer than ``min_samples`` samples have no defined variance and
        are dropped too (they carry no skippable confidence).  Applied at
        ``prior=`` seeding via ``AutotuneSession(prior_max_cv=...)``."""
        out = {}
        for k, st in self.entries.items():
            if st.n < min_samples or st.mean <= 0.0:
                continue
            if st.std / st.mean <= max_cv:
                out[k] = st.copy()
        return StatisticsBank(
            out, meta=self.meta + [{"filter_max_cv": max_cv}])

    # -- Gaussian-copula-style quantile remap --------------------------------

    def remapped(self, target: "StatisticsBank", *,
                 min_matches: int = 3) -> "StatisticsBank":
        """Remap this (source) bank onto ``target``'s sample distributions.

        For each kernel present in both banks, the source distribution is
        pushed through the monotone quantile map source-CDF -> uniform ->
        target-CDF.  With Gaussian marginals that map is the affine z-score
        transform, so the remapped kernel carries the TARGET's marginal
        (mean/variance/extremes) while pooling both banks' sample counts —
        the copula transfer: confidence structure from the source, marginal
        from the target.

        Source-only kernels are rescaled through a global log-space
        least-squares fit ``log t_target = a * log t_source + b`` over the
        matched pairs' means (a plain median mean-ratio below
        ``min_matches`` pairs; identity with no matches), then
        evidence-kept via ``KernelStats.scaled``.  Target-only kernels pass
        through unchanged.
        """
        src, tgt = self.entries, target.entries
        matched = [k for k in src if k in tgt
                   and src[k].mean > 0 and tgt[k].mean > 0]
        out: Dict[str, KernelStats] = {}
        for k in matched:
            s, t = src[k], tgt[k]
            n = t.n + s.n
            var = t.variance
            if not math.isfinite(var):
                # target too thin for a variance: borrow the source's
                # relative spread at the target's location
                svar = s.variance
                var = svar * (t.mean / s.mean) ** 2 \
                    if math.isfinite(svar) else 0.0
            out[k] = KernelStats.from_moments(n, t.mean, var,
                                              min(t.min_t, t.mean),
                                              max(t.max_t, t.mean))
        a, b = _fit_loglinear([(src[k].mean, tgt[k].mean) for k in matched],
                              min_matches)
        for k, s in src.items():
            if k in out:
                continue
            scale = math.exp(a * math.log(s.mean) + b) / s.mean \
                if s.mean > 0 else 1.0
            out[k] = s.scaled(scale)
        for k, t in tgt.items():
            if k not in out:
                out[k] = t.copy()
        return StatisticsBank(out, meta=self.meta + target.meta +
                              [{"remap": {"a": a, "b": b,
                                          "matched": len(matched)}}])

    # -- session-side resolution ---------------------------------------------

    def resolver(self, world_size: int
                 ) -> Callable[[Signature], Optional[KernelStats]]:
        """A ``Signature -> KernelStats-or-None`` lookup for a target study
        at ``world_size`` ranks.  Every hit returns a fresh copy (two
        signatures may resolve to one entry and must not share state)."""
        entries = self.entries
        memo: Dict[Signature, Optional[KernelStats]] = {}

        def lookup(sig: Signature) -> Optional[KernelStats]:
            st = memo.get(sig, False)
            if st is False:
                st = memo[sig] = entries.get(structural_key(sig, world_size))
            return st.copy() if st is not None else None

        return lookup

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        return {"version": BANK_VERSION,
                "entries": {k: self.entries[k].to_json()
                            for k in sorted(self.entries)},
                "meta": self.meta}

    @classmethod
    def from_json(cls, d: dict) -> "StatisticsBank":
        if d.get("version", BANK_VERSION) != BANK_VERSION:
            raise ValueError(
                f"statistics bank version {d.get('version')!r} "
                f"unsupported (want {BANK_VERSION})")
        return cls({k: KernelStats.from_json(v)
                    for k, v in d["entries"].items()},
                   meta=list(d.get("meta", [])))

    def save(self, path: str) -> None:
        """Durably replace ``path`` with this bank: write to a same-
        directory mkstemp file, fsync, then atomically rename — a crash at
        any point leaves either the old bank or the new one, never a
        truncated hybrid (the daemon persists the fleet bank on a timer)."""
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".", suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "StatisticsBank":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def fingerprint(self) -> str:
        """Content hash for session checkpoint keys: a journaled result
        produced under one prior must never be replayed under another."""
        payload = dumps_canonical(
            {"entries": {k: v.to_json() for k, v in self.entries.items()}})
        return f"bank:{zlib.crc32(payload.encode()):08x}:{len(self.entries)}"


def _fit_loglinear(pairs: List[Tuple[float, float]],
                   min_matches: int) -> Tuple[float, float]:
    """log-space least squares through (source mean, target mean) pairs;
    degrades to a median-ratio shift, then to identity.  The slope is
    clamped to be non-negative: the remap must stay a monotone quantile
    map (a negative fitted slope — possible on adversarial matched pairs —
    would invert the source ordering, which no CDF->CDF map can do)."""
    if not pairs:
        return 1.0, 0.0
    logs = [(math.log(s), math.log(t)) for s, t in pairs]
    if len(logs) < max(min_matches, 2):
        ratios = sorted(lt - ls for ls, lt in logs)
        return 1.0, ratios[len(ratios) // 2]
    n = len(logs)
    mx = sum(ls for ls, _ in logs) / n
    my = sum(lt for _, lt in logs) / n
    sxx = sum((ls - mx) ** 2 for ls, _ in logs)
    if sxx <= 0.0:
        return 1.0, my - mx
    sxy = sum((ls - mx) * (lt - my) for ls, lt in logs)
    a = max(sxy / sxx, 0.0)
    return a, my - a * mx


# ------------------------------------------------- Gaussian-copula sampler

def _norm_ppf(q: float) -> float:
    """Standard-normal inverse CDF (Acklam's rational approximation,
    |relative error| < 1.15e-9 — far inside the marginals' own CI width).
    Dependency-free so the sampler needs nothing beyond numpy."""
    if not 0.0 < q < 1.0:
        if q == 0.0:
            return -math.inf
        if q == 1.0:
            return math.inf
        raise ValueError(f"quantile level {q!r} outside [0, 1]")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    lo, hi = 0.02425, 1.0 - 0.02425
    if q < lo:
        u = math.sqrt(-2.0 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                * u + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u
                                + d[3]) * u + 1.0)
    if q > hi:
        u = math.sqrt(-2.0 * math.log(1.0 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                 * u + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u
                                 + d[3]) * u + 1.0)
    u = q - 0.5
    r = u * u
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * u / (((((b[0] * r + b[1]) * r + b[2]) * r
                                 + b[3]) * r + b[4]) * r + 1.0)


def _equicorrelation(banks: Sequence["StatisticsBank"],
                     keys: Sequence[str]) -> float:
    """Estimate the one-factor (equicorrelated) Gaussian-copula dependence
    across kernels from per-bank log-mean observations.

    Each bank contributes one observation of the per-kernel mean vector;
    after standardizing every kernel's log-mean across banks, the variance
    of the per-bank cross-kernel average identifies rho (for standardized
    equicorrelated z's, Var[mean_k z_k] = (1 + (K-1) rho) / K).  A single
    bank — one observation — carries no dependence evidence: rho = 0,
    independent marginals."""
    if len(banks) < 2:
        return 0.0
    common = [k for k in keys
              if all(k in b.entries and b.entries[k].mean > 0
                     for b in banks)]
    if len(common) < 2:
        return 0.0
    x = np.log([[b.entries[k].mean for k in common] for b in banks])
    sd = x.std(axis=0)
    ok = sd > 0
    if int(ok.sum()) < 2:
        return 0.0
    z = (x[:, ok] - x[:, ok].mean(axis=0)) / sd[ok]
    k = z.shape[1]
    v = float(np.mean(z.mean(axis=1) ** 2))
    rho = (k * v - 1.0) / (k - 1.0)
    return float(min(max(rho, 0.0), 0.99))


class CopulaModel:
    """Seeded generative view of recorded banks: per-kernel Gaussian
    marginals joined by a one-factor Gaussian copula.

    ``fit`` Chan-merges one or more ``StatisticsBank``s into per-key
    (mean, std) marginals — the same moments the quantile remap maps
    between — and estimates a single empirical equicorrelation ``rho``
    from the banks' per-kernel mean vectors (machines/allocations whose
    kernels are all systematically fast or slow together).  ``sample``
    draws joint kernel-time vectors: a shared factor ``g`` plus
    independent noise, pushed through each marginal's quantile transform
    (Gaussian marginals: the affine z-score map — ``quantile`` exposes the
    per-key inverse CDF), clipped at zero since times are nonnegative.

    Degenerate inputs degrade, never raise: an empty bank yields a falsy
    model whose ``sample`` returns shape ``(n, 0)`` (callers fall back to
    uniform candidate sampling); a single kernel gets one marginal;
    zero-variance or single-sample entries get ``std = 0`` — constant
    draws at the mean.  Round-trips losslessly through JSON and
    fingerprints for checkpoint identity like the banks it came from.
    """

    def __init__(self, keys: Sequence[str], mean, std, n, rho: float = 0.0,
                 *, meta: Optional[List[dict]] = None):
        self.keys: List[str] = list(keys)
        self.mean = np.asarray(mean, dtype=float)
        self.std = np.asarray(std, dtype=float)
        self.n = np.asarray(n, dtype=int)
        self.rho = float(rho)
        self.meta: List[dict] = list(meta or [])

    def __len__(self) -> int:
        return len(self.keys)

    def __bool__(self) -> bool:
        return bool(self.keys)

    @classmethod
    def fit(cls, banks: Sequence["StatisticsBank"]) -> "CopulaModel":
        """Fit marginals over the Chan-merged union of ``banks`` and the
        cross-bank equicorrelation (0 with fewer than two banks)."""
        banks = [b if isinstance(b, StatisticsBank)
                 else StatisticsBank.from_json(b) for b in banks]
        merged = StatisticsBank()
        for b in banks:
            merged = merged.merge(b)
        keys = sorted(k for k, st in merged.entries.items() if st.mean > 0)
        mean, std, nobs = [], [], []
        for k in keys:
            st = merged.entries[k]
            var = st.variance
            mean.append(st.mean)
            std.append(math.sqrt(var)
                       if st.n >= 2 and math.isfinite(var) else 0.0)
            nobs.append(st.n)
        return cls(keys, mean, std, nobs, _equicorrelation(banks, keys),
                   meta=[m for b in banks for m in b.meta])

    def quantile(self, key: str, q: float) -> float:
        """Per-key marginal inverse CDF (monotone non-decreasing in ``q``;
        ``quantile(key, 0.5)`` is the key's mean — the remap machinery's
        marginal-preservation, pointwise)."""
        i = self.keys.index(key)
        return max(float(self.mean[i] + self.std[i] * _norm_ppf(q)), 0.0)

    def sample(self, n: int, rng) -> np.ndarray:
        """``(n, len(keys))`` joint kernel-time draws.  ``rng`` is a
        ``numpy.random.Generator`` or an int seed; the same seed yields
        the same draws on any process — the determinism the model-guided
        checkpoint carry relies on."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(int(rng))
        k = len(self.keys)
        if k == 0:
            return np.zeros((int(n), 0))
        g = rng.standard_normal((int(n), 1))
        e = rng.standard_normal((int(n), k))
        z = math.sqrt(self.rho) * g + math.sqrt(1.0 - self.rho) * e
        return np.maximum(self.mean + self.std * z, 0.0)

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        return {"version": COPULA_VERSION, "keys": list(self.keys),
                "mean": [float(v) for v in self.mean],
                "std": [float(v) for v in self.std],
                "n": [int(v) for v in self.n],
                "rho": self.rho, "meta": self.meta}

    @classmethod
    def from_json(cls, d: dict) -> "CopulaModel":
        if d.get("version", COPULA_VERSION) != COPULA_VERSION:
            raise ValueError(
                f"copula model version {d.get('version')!r} unsupported "
                f"(want {COPULA_VERSION})")
        return cls(d["keys"], d["mean"], d["std"], d["n"], d["rho"],
                   meta=list(d.get("meta", [])))

    def fingerprint(self) -> str:
        payload = dumps_canonical(
            {k: v for k, v in self.to_json().items() if k != "meta"})
        return f"copula:{zlib.crc32(payload.encode()):08x}:{len(self)}"
