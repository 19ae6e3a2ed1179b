"""Uniform study results for every tuning path.

``ConfigRecord`` is the per-configuration measurement row and
``StudyResult`` the study-level report, shared by all backends (virtual
machine, wall clock, dry run) and both search drivers.  They carry the
paper's §VI.A quantities — relative prediction error, autotuning speedup,
optimum selection quality — plus backend/search provenance, and round-trip
losslessly through JSON (``to_json``/``from_json``), which is what session
checkpointing, the parallel sweep's result pipes, and the
``benchmarks/results/`` writers all rely on.

``repro.core.tuner`` re-exports these under their historical names
(``ConfigRecord``, ``StudyReport``) for pinned tests; new code should
import from ``repro.api``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .serialize import from_jsonable, to_jsonable


@dataclass
class ConfigRecord:
    """One configuration's measurements (identical across backends)."""

    name: str
    params: dict
    full_time: float          # full-execution reference performed just prior
    predicted: float          # selective-execution estimate (last trial)
    rel_error: float
    comp_error: float
    selective_cost: float     # wall time paid for this config's trials
    full_cost: float          # what full execution would have paid
    executed: int
    skipped: int
    predictions: List[float] = field(default_factory=list)
    extra: dict = field(default_factory=dict)   # backend-specific payload

    def to_json(self) -> dict:
        return {
            "name": self.name, "params": to_jsonable(self.params),
            "full_time": to_jsonable(self.full_time),
            "predicted": to_jsonable(self.predicted),
            "rel_error": to_jsonable(self.rel_error),
            "comp_error": to_jsonable(self.comp_error),
            "selective_cost": to_jsonable(self.selective_cost),
            "full_cost": to_jsonable(self.full_cost),
            "executed": int(self.executed), "skipped": int(self.skipped),
            "predictions": to_jsonable(self.predictions),
            "extra": to_jsonable(self.extra),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ConfigRecord":
        return cls(
            name=d["name"], params=from_jsonable(d["params"]),
            full_time=from_jsonable(d["full_time"]),
            predicted=from_jsonable(d["predicted"]),
            rel_error=from_jsonable(d["rel_error"]),
            comp_error=from_jsonable(d["comp_error"]),
            selective_cost=from_jsonable(d["selective_cost"]),
            full_cost=from_jsonable(d["full_cost"]),
            executed=d["executed"], skipped=d["skipped"],
            predictions=from_jsonable(d["predictions"]),
            extra=from_jsonable(d.get("extra", {})))


@dataclass
class StudyResult:
    """What one (study, policy, tolerance) tuning run produced."""

    study: str
    policy: str
    tolerance: float
    records: List[ConfigRecord]
    full_tuning_time: float
    selective_tuning_time: float
    backend: str = ""
    search: str = "exhaustive"
    seed: int = 0
    allocation: int = 0
    wall_s: float = 0.0
    extra: dict = field(default_factory=dict)   # search-specific artifacts

    @property
    def speedup(self) -> float:
        if self.full_tuning_time <= 0:
            # no full-execution reference (racing never measures one):
            # a full/selective ratio is undefined, not zero
            return math.nan
        if self.selective_tuning_time <= 0:
            return math.inf
        return self.full_tuning_time / self.selective_tuning_time

    @property
    def mean_error(self) -> float:
        return float(np.mean([r.rel_error for r in self.records]))

    @property
    def mean_comp_error(self) -> float:
        return float(np.mean([r.comp_error for r in self.records]))

    @property
    def chosen(self) -> ConfigRecord:
        return min(self.records, key=lambda r: r.predicted)

    @property
    def true_best(self) -> ConfigRecord:
        return min(self.records, key=lambda r: r.full_time)

    @property
    def optimum_quality(self) -> float:
        """full-execution time of the truly-best config divided by that of
        the chosen config (1.0 = optimal choice; paper reports >= 0.99).
        NaN when the study has no full-execution reference (racing)."""
        chosen = self.chosen.full_time
        if chosen <= 0:
            return math.nan
        return self.true_best.full_time / chosen

    def stats_bank(self):
        """The per-kernel statistics bank a ``collect_stats=True`` session
        attached to this result (``None`` when the study did not collect)
        — feed it to a later session as ``prior=`` (see
        ``repro.api.transfer``)."""
        if "kernel_stats" not in self.extra:
            return None
        from .transfer import StatisticsBank
        return StatisticsBank.from_result(self)

    def row(self) -> dict:
        return {
            "study": self.study, "policy": self.policy,
            "tolerance": self.tolerance, "speedup": self.speedup,
            "mean_error": self.mean_error,
            "mean_comp_error": self.mean_comp_error,
            "optimum_quality": self.optimum_quality,
            "full_time": self.full_tuning_time,
            "selective_time": self.selective_tuning_time,
        }

    def to_json(self) -> dict:
        return {
            "study": self.study, "policy": self.policy,
            "tolerance": to_jsonable(self.tolerance),
            "records": [r.to_json() for r in self.records],
            "full_tuning_time": to_jsonable(self.full_tuning_time),
            "selective_tuning_time":
                to_jsonable(self.selective_tuning_time),
            "backend": self.backend, "search": self.search,
            "seed": int(self.seed), "allocation": int(self.allocation),
            "wall_s": to_jsonable(self.wall_s),
            "extra": to_jsonable(self.extra),
        }

    @classmethod
    def from_json(cls, d: dict) -> "StudyResult":
        return cls(
            study=d["study"], policy=d["policy"],
            tolerance=from_jsonable(d["tolerance"]),
            records=[ConfigRecord.from_json(r) for r in d["records"]],
            full_tuning_time=from_jsonable(d["full_tuning_time"]),
            selective_tuning_time=from_jsonable(
                d["selective_tuning_time"]),
            backend=d.get("backend", ""),
            search=d.get("search", "exhaustive"),
            seed=d.get("seed", 0), allocation=d.get("allocation", 0),
            wall_s=from_jsonable(d.get("wall_s", 0.0)),
            extra=from_jsonable(d.get("extra", {})))
