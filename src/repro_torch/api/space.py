"""Declarative tuning spaces.

A ``SearchSpace`` is the backend-agnostic description of WHAT is being
tuned: named configuration points (each carrying display params and an
opaque backend payload — a simmpi program factory, a ``StepKnobs``, a
dry-run ``SearchPoint``), plus the study-level protocol switches the paper
distinguishes (whether kernel statistics reset between configurations) and
sizing hints for the virtual-machine backend.

Space constructors for the repo's concrete studies live next to their
payloads: ``repro.linalg.studies.search_space`` (sim),
``repro.tune.lm_study.LMStudy.search_space`` (wall clock),
``repro.api.backends.dryrun_space`` (dry run).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Iterator, List, Optional

#: reset_between_configs value meaning "follow the policy": reset unless
#: the policy keeps persistent models (eager's cross-config reuse) — the
#: convention of the measured LM studies.
RESET_POLICY = "policy"


@dataclass(frozen=True)
class ConfigPoint:
    """One point of a tuning space."""

    name: str
    params: dict = field(default_factory=dict)
    payload: Any = None     # backend-specific configuration object


@dataclass
class SearchSpace:
    """A named list of configuration points sharing one measurement
    substrate (one virtual machine / one model under timing / one mesh)."""

    name: str
    points: List[ConfigPoint]
    # paper §VI.A: SLATE/CANDMC reset kernel statistics between
    # configurations; Capital does not (eager reuses models across
    # configs).  RESET_POLICY defers the choice to the policy.
    reset_between_configs: Any = True
    # sim-backend sizing hints (ignored by other backends)
    world_size: int = 0
    machine: Any = None

    def __post_init__(self):
        # The points list IS the enumeration contract: checkpoints journal
        # per-configuration records by position, and the model-guided
        # driver selects candidates by sampled index — both replayed
        # across processes and resume boundaries.  Enumeration order is
        # therefore pinned to construction order (list order; never
        # re-sorted), and names must be unambiguous since records and
        # journal entries key on them.
        seen = set()
        for p in self.points:
            if p.name in seen:
                raise ValueError(
                    f"space {self.name!r} enumerates point {p.name!r} "
                    "twice; point names key records and checkpoint "
                    "journal entries and must be unique")
            seen.add(p.name)

    def __iter__(self) -> Iterator[ConfigPoint]:
        return iter(self.points)

    def __len__(self) -> int:
        return len(self.points)

    def order_fingerprint(self) -> str:
        """Stable identity of the point enumeration *order* (crc over the
        name sequence — process-independent by construction).  Journaled
        with the model-guided sampler state; resume refuses to map a
        checkpointed candidate selection onto a space that enumerates
        differently."""
        names = "\x1f".join(p.name for p in self.points)
        return f"order:{zlib.crc32(names.encode()):08x}:{len(self.points)}"

    def subset(self, n: Optional[int]) -> "SearchSpace":
        """First-n-points view (same substrate), for fast CI passes."""
        if n is None or n >= len(self.points):
            return self
        return replace(self, points=self.points[:n])

    def should_reset(self, policy) -> bool:
        """Resolve reset_between_configs against a concrete policy."""
        if self.reset_between_configs == RESET_POLICY:
            return not policy.persistent_models
        return bool(self.reset_between_configs)
