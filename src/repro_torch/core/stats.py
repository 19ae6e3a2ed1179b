"""Single-pass statistical models of kernel execution time.

Implements the paper's statistical characterization (§III.A):

- every kernel signature's measured time is a random variable X with finite
  mean/variance; we keep a Welford single-pass estimator of (mean, M2);
- the confidence interval for the sample mean uses the (scaled) sample
  variance at a 95% confidence level (the paper's default);
- knowledge that a kernel executes ``k`` times along the current sub-critical
  path lets us assign sample variance ``sigma^2 / k`` to its contribution,
  shrinking the confidence interval needed per kernel by ``sqrt(k)``
  (paper: "Knowing that the number of times a kernel is executed along the
  critical path is alpha allows us to assign a sample variance sigma^2/alpha
  ... reduces the confidence interval ... by a factor sqrt(alpha)").
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# 95% two-sided normal quantile. The paper constructs 95% confidence
# intervals from the scaled sample variance; for very small n we widen via a
# small-sample t-style correction table (indexed by dof) so that 2-3 samples
# are not spuriously declared "predictable".
Z_95 = 1.959963984540054

# student-t 97.5% quantiles for dof 1..30 (then ~z).
_T_975 = [
    12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262, 2.228,
    2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101, 2.093, 2.086,
    2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052, 2.048, 2.045, 2.042,
]


def t_quantile_975(dof: int) -> float:
    if dof <= 0:
        return math.inf
    if dof <= len(_T_975):
        return _T_975[dof - 1]
    return Z_95


# Acklam's rational approximation of the standard-normal inverse CDF
# (~1.15e-9 absolute error).  The counter-based RNG discipline in
# simmpi.costmodel maps uniform counters to normal deviates through this
# function; it is vectorized so a whole segment's draws evaluate in one
# ufunc pass, and the scalar path evaluates the SAME ufuncs on length-1
# arrays so per-event and per-segment draws are bitwise identical.
_PPF_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_PPF_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_PPF_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_PPF_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
_PPF_LO = 0.02425


def norm_ppf(q: "np.ndarray") -> "np.ndarray":
    """Vectorized standard-normal quantile function on ``q`` in (0, 1)."""
    q = np.asarray(q, dtype=np.float64)
    out = np.empty_like(q)
    a, b, c, d = _PPF_A, _PPF_B, _PPF_C, _PPF_D
    low = q < _PPF_LO
    high = q > 1.0 - _PPF_LO
    mid = ~(low | high)
    if low.any():
        u = np.sqrt(-2.0 * np.log(q[low]))
        out[low] = ((((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u
                      + c[4]) * u + c[5])
                    / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u
                       + 1.0))
    if high.any():
        u = np.sqrt(-2.0 * np.log(1.0 - q[high]))
        out[high] = -((((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u
                        + c[4]) * u + c[5])
                      / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u
                         + 1.0))
    if mid.any():
        u = q[mid] - 0.5
        r = u * u
        out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r
                      + a[4]) * r + a[5]) * u
                    / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                        + b[4]) * r + 1.0))
    return out


@dataclass
class KernelStats:
    """Welford single-pass estimator of a kernel signature's execution time.

    This is the per-signature record the paper stores in the local kernel set
    (K-bar): sample count, mean, M2 (sum of squared deviations), plus
    min/max/total for reporting.
    """

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    total: float = 0.0
    min_t: float = math.inf
    max_t: float = 0.0
    #: wall-clock time (time.time()) the evidence was last refreshed, or
    #: None for unstamped records (every pre-daemon bank).  Carried through
    #: copy/merge/discount and the JSON round-trip, but excluded from
    #: equality and OMITTED from JSON when unset so stamped-free banks
    #: serialize (and fingerprint) exactly as before.
    last_updated: "Optional[float]" = field(default=None, compare=False)
    # -- engine-hot-path caches (all keyed on n, which strictly increases on
    # every update/merge, so a stale cache is detected by n alone) ----------
    # t-quantile x std / sqrt(n) factor, valid while _hw_n == n
    _hw_n: int = field(default=-1, init=False, repr=False, compare=False)
    _hw: float = field(default=math.inf, init=False, repr=False, compare=False)
    # memoized predictability verdicts: relative_ci is monotone nonincreasing
    # in freq, so one True verdict at freq f certifies every freq >= f and
    # one False verdict certifies every freq <= f.
    _pred_n: int = field(default=-1, init=False, repr=False, compare=False)
    _pred_tol: float = field(default=math.nan, init=False, repr=False,
                             compare=False)
    _pred_true: float = field(default=math.inf, init=False, repr=False,
                              compare=False)
    _pred_false: int = field(default=0, init=False, repr=False, compare=False)

    def update(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)
        self.total += x
        if x < self.min_t:
            self.min_t = x
        if x > self.max_t:
            self.max_t = x

    def update_many(self, xs) -> None:
        """Fold a batch of samples, in order, with the exact arithmetic of
        repeated ``update`` calls (same operations, same order — bitwise-
        identical results; a Chan-style batch merge would NOT be).  The
        engine's batched cold path uses this to amortize attribute access
        over a fused kernel run; the memo caches below stay keyed on ``n``
        and invalidate as usual."""
        n = self.n
        mean = self.mean
        m2 = self.m2
        total = self.total
        min_t = self.min_t
        max_t = self.max_t
        for x in xs:
            n += 1
            delta = x - mean
            mean += delta / n
            m2 += delta * (x - mean)
            total += x
            if x < min_t:
                min_t = x
            if x > max_t:
                max_t = x
        self.n = n
        self.mean = mean
        self.m2 = m2
        self.total = total
        self.min_t = min_t
        self.max_t = max_t

    def merge(self, other: "KernelStats") -> None:
        """Chan et al. parallel merge — used when propagating statistics
        across channels (aggregate_statistics in Figure 2)."""
        if other.n == 0:
            return
        if other.last_updated is not None and (
                self.last_updated is None
                or other.last_updated > self.last_updated):
            self.last_updated = other.last_updated
        if self.n == 0:
            self.n = other.n
            self.mean = other.mean
            self.m2 = other.m2
            self.total = other.total
            self.min_t = other.min_t
            self.max_t = other.max_t
            return
        n = self.n + other.n
        delta = other.mean - self.mean
        self.mean += delta * other.n / n
        self.m2 += other.m2 + delta * delta * self.n * other.n / n
        self.n = n
        self.total += other.total
        self.min_t = min(self.min_t, other.min_t)
        self.max_t = max(self.max_t, other.max_t)

    # -- derived quantities -------------------------------------------------

    @property
    def variance(self) -> float:
        """Unbiased sample variance."""
        if self.n < 2:
            return math.inf
        return self.m2 / (self.n - 1)

    @property
    def std(self) -> float:
        v = self.variance
        return math.sqrt(v) if v != math.inf else math.inf

    def ci_halfwidth(self, freq: int = 1) -> float:
        """95% CI half-width of the sample mean, shrunk by sqrt(freq).

        ``freq`` is the kernel's execution count along the current
        sub-critical path (alpha in the paper); passing freq=1 recovers the
        plain CI (the ``conditional execution`` policy).
        """
        if self.n < 2:
            return math.inf
        if self._hw_n != self.n:
            q = t_quantile_975(self.n - 1)
            self._hw = q * self.std / math.sqrt(self.n)
            self._hw_n = self.n
        hw = self._hw
        if freq > 1:
            hw /= math.sqrt(freq)
        return hw

    def relative_ci(self, freq: int = 1) -> float:
        """epsilon-tilde: CI size divided by sample mean (paper §III.A)."""
        if self.mean <= 0.0:
            return math.inf
        return self.ci_halfwidth(freq) / self.mean

    def is_predictable(self, tolerance: float, freq: int = 1,
                       min_samples: int = 2) -> bool:
        """True once relative CI size falls below the confidence tolerance."""
        if self.n < min_samples:
            return False
        if self._pred_n != self.n or self._pred_tol != tolerance:
            self._pred_n = self.n
            self._pred_tol = tolerance
            self._pred_true = math.inf
            self._pred_false = 0
        if freq >= self._pred_true:
            return True
        if freq <= self._pred_false:
            return False
        ok = self.relative_ci(freq) <= tolerance
        if ok:
            self._pred_true = freq
        else:
            self._pred_false = freq
        return ok

    def copy(self) -> "KernelStats":
        return KernelStats(self.n, self.mean, self.m2, self.total,
                           self.min_t, self.max_t, self.last_updated)

    # -- transfer / serialization -------------------------------------------
    #
    # The sufficient statistics (n, mean, m2) plus the reporting extras
    # (total, min, max) fully determine every derived quantity above, so a
    # bank of exported KernelStats can re-enter a later study as a prior
    # (repro.api.transfer) with nothing lost.  The memo caches are NOT
    # exported: they are keyed on n and rebuild on first use.

    def to_json(self) -> dict:
        d = {"n": int(self.n), "mean": float(self.mean),
             "m2": float(self.m2), "total": float(self.total)}
        if self.n > 0:          # min_t is +inf until the first sample
            d["min"] = float(self.min_t)
            d["max"] = float(self.max_t)
        if self.last_updated is not None:
            d["last_updated"] = float(self.last_updated)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "KernelStats":
        n = int(d["n"])
        lu = d.get("last_updated")
        return cls(n, float(d["mean"]), float(d["m2"]), float(d["total"]),
                   float(d["min"]) if n > 0 else math.inf,
                   float(d["max"]) if n > 0 else 0.0,
                   float(lu) if lu is not None else None)

    @classmethod
    def from_moments(cls, n: int, mean: float, variance: float,
                     min_t: float = None, max_t: float = None
                     ) -> "KernelStats":
        """Build the sufficient statistics of an n-sample stream with the
        given mean and (unbiased) variance — the synthesis direction of the
        copula remap, where a transferred marginal replaces the raw
        samples."""
        m2 = variance * (n - 1) if n >= 2 and math.isfinite(variance) \
            else 0.0
        return cls(n, mean, m2, mean * n,
                   mean if min_t is None else min_t,
                   mean if max_t is None else max_t)

    def discounted(self, factor: float) -> "KernelStats":
        """A weakened copy carrying ``factor`` of the evidence: the mean and
        variance are preserved but the effective sample count shrinks, so a
        transferred prior widens its CI (and re-crosses the predictability
        threshold) unless the source really was confident.  ``factor >= 1``
        returns a plain copy; a prior discounted to n < 1 carries no
        evidence (n = 0)."""
        if factor >= 1.0:
            return self.copy()
        # round, don't truncate: an age discount epsilon under 1.0 must
        # not destroy a whole sample of evidence (n=2 -> 1 would knock a
        # freshly banked kernel back below min_samples)
        n = int(round(self.n * factor))
        if n <= 0:
            return KernelStats()
        out = KernelStats.from_moments(n, self.mean, self.variance,
                                       self.min_t, self.max_t)
        out.last_updated = self.last_updated
        return out

    def discount_by_age(self, now: float, half_life: float
                        ) -> "KernelStats":
        """Age-aware ``discounted``: evidence decays exponentially in wall
        clock, halving every ``half_life`` seconds since ``last_updated``.
        Unstamped records (no ``last_updated``) carry no age and pass
        through as plain copies — a pre-daemon bank is trusted as-is."""
        if self.last_updated is None:
            return self.copy()
        age = now - self.last_updated
        if age <= 0.0:
            return self.copy()
        return self.discounted(0.5 ** (age / half_life))

    def minus(self, prior: "KernelStats") -> "Optional[KernelStats]":
        """Approximate inverse of ``merge``: the sufficient statistics of
        the samples in ``self`` beyond those of ``prior`` (assuming ``self
        == merge(prior, delta)``).  Used by the transfer harvest so a
        seeded prior's evidence is not re-banked on every model reset.
        Returns ``None`` when there is nothing beyond the prior; min/max
        are kept from ``self`` (extremes cannot be un-merged)."""
        nd = self.n - prior.n
        if nd <= 0:
            return None
        total = self.total - prior.total
        mean = (self.n * self.mean - prior.n * prior.mean) / nd
        d = mean - prior.mean
        m2 = self.m2 - prior.m2 - d * d * prior.n * nd / self.n
        if m2 < 0.0:                   # float cancellation guard
            m2 = 0.0
        return KernelStats(nd, mean, m2, total, self.min_t, self.max_t,
                           self.last_updated)

    def scaled(self, a: float) -> "KernelStats":
        """The statistics of ``a * X`` — the affine (through-origin) image
        used when a fitted source->target time map rescales a transferred
        kernel distribution."""
        if self.n == 0:
            return KernelStats()
        return KernelStats(self.n, a * self.mean, a * a * self.m2,
                           a * self.total, a * self.min_t, a * self.max_t,
                           self.last_updated)
