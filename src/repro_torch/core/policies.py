"""Selective kernel-execution policies (paper §IV.B).

Five policies, ordered from most conservative to most aggressive:

- ``conditional``  — no execution-count usage: a kernel is skipped only when
  its plain CI satisfies the tolerance. Executes every kernel at least once
  per tuning iteration.
- ``local``        — like conditional, but the CI is shrunk by sqrt(freq)
  using only *locally observed* execution counts.
- ``online``       — critical-path execution counts are propagated online
  between processors (longest-path algorithm) and used to shrink the CI.
- ``apriori``      — one initial full iteration records exact critical-path
  counts, which subsequent iterations apply immediately (the extra full
  execution is charged to the autotuning time, as in the paper).
- ``eager``        — a kernel is switched off globally as soon as a single
  processor deems it predictable *and* its statistics have been propagated
  across aggregate channels spanning the whole machine; kernels are NOT
  re-executed once per iteration, and models persist across configurations
  that share kernel signatures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

POLICIES = ("conditional", "local", "online", "apriori", "eager")


@dataclass(frozen=True)
class Policy:
    name: str
    # confidence tolerance epsilon: relative CI size below which a kernel's
    # time is considered sufficiently predictable.
    tolerance: float = 0.25
    # minimum samples before a kernel may be considered predictable
    min_samples: int = 3
    # fraction of a communication kernel's sub-communicator that must deem it
    # predictable for the execution to be skipped (default: all).
    comm_vote_fraction: float = 1.0
    # beyond-paper: allow the tuner to predict kernels never executed, via
    # per-op-family input-size extrapolation models (paper §VIII future work)
    extrapolate: bool = False

    def __post_init__(self):
        if self.name not in POLICIES:
            raise ValueError(f"unknown policy {self.name!r}; want one of {POLICIES}")

    @property
    def uses_counts(self) -> bool:
        return self.name in ("local", "online", "apriori")

    @property
    def propagates_counts(self) -> bool:
        return self.name == "online"

    @property
    def needs_offline_pass(self) -> bool:
        return self.name == "apriori"

    @property
    def once_per_iteration(self) -> bool:
        """All methods except eager execute each kernel at least once per
        tuning iteration (paper §VI.A)."""
        return self.name != "eager"

    @property
    def persistent_models(self) -> bool:
        """Eager propagation reuses kernel performance models across
        configurations (paper §VI.B)."""
        return self.name == "eager"


def policy(name: str, tolerance: float = 0.25, **kw) -> Policy:
    return Policy(name=name, tolerance=tolerance, **kw)
