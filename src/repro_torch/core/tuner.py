"""The approximate autotuner — legacy entry point.

.. deprecated::
    ``repro.api`` is the supported front-end: ``AutotuneSession`` over a
    ``SimBackend`` subsumes everything here (plus wall-clock and dry-run
    backends, process-parallel sweeps, and checkpoint/resume).  This
    module remains as a thin shim because the golden-report regression
    and the published benchmarks pin its exact protocol; the measurement
    logic itself lives in ``repro.api.search`` (drivers) and
    ``repro.api.backends.SimBackend`` (virtual-machine execution).

Drives a configuration-space search over a study (a set of schedule
configurations sharing a virtual machine), measuring what the paper
measures (§VI.A):

- per-configuration *relative prediction error*: selective-execution
  estimate vs a full execution performed directly prior;
- *autotuning speedup*: total benchmark time under full kernel execution vs
  under selective execution (including policy extras such as the a-priori
  offline pass);
- *optimum selection quality*: the configuration the tuner would pick vs
  the configuration a full-execution exhaustive search picks.

Exhaustive search mirrors the paper's evaluation; ``tune_racing`` is the
beyond-paper integration of the paper's own confidence intervals with a
racing/successive-halving search that prunes configurations whose CI lower
bound exceeds the incumbent's upper bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.api.result import ConfigRecord, StudyResult
from repro_torch.api.search import exhaustive, measure_config, racing
from repro_torch.api.space import ConfigPoint, SearchSpace
from repro_torch.simmpi.costmodel import CostModel, MachineSpec, KNL_STAMPEDE2

from .policies import Policy

#: historical name for the uniform study report (same class; the api name
#: is ``StudyResult``)
StudyReport = StudyResult


@dataclass
class Configuration:
    """One point of the tuning space: a named schedule generator."""

    name: str
    params: dict
    # make_program(world) -> program_factory(rank, world) -> generator
    make_program: Callable[["World"], Callable]


@dataclass
class Study:
    """A tuning study: configurations sharing one virtual machine."""

    name: str
    world_size: int
    configs: List[Configuration]
    # paper §VI.A: SLATE/CANDMC reset kernel statistics between
    # configurations; Capital does not (eager reuses models across configs)
    reset_between_configs: bool = True
    machine: MachineSpec = KNL_STAMPEDE2


def space_of_study(study: Study) -> SearchSpace:
    """Adapt a legacy ``Study`` to the session API's ``SearchSpace``."""
    return SearchSpace(
        name=study.name,
        points=[ConfigPoint(name=c.name, params=c.params,
                            payload=c.make_program)
                for c in study.configs],
        reset_between_configs=study.reset_between_configs,
        world_size=study.world_size, machine=study.machine)


class Autotuner:
    """Exhaustive (paper) and racing (beyond-paper) searches.

    Thin shim over ``repro.api``: builds a ``SimBackend`` run and
    delegates to the lifted search drivers.  ``world``/``critter``/
    ``runtime`` stay exposed — benchmarks introspect them.
    """

    def __init__(self, study: Study, policy: Policy, *,
                 trials: int = 3, seed: int = 0, allocation: int = 0,
                 timer: Optional[Callable] = None,
                 cost_model: Optional[CostModel] = None,
                 overhead: float = 1e-6):
        from repro_torch.api.backends import SimBackend   # avoid import cycle
        self.study = study
        self.policy = policy
        self.trials = trials
        self.space = space_of_study(study)
        self._run = SimBackend(
            machine=study.machine, timer=timer, cost_model=cost_model,
            overhead=overhead).open(self.space, policy, seed=seed,
                                    allocation=allocation)
        self.world = self._run.world
        self.critter = self._run.critter
        self.runtime = self._run.runtime

    # -- exhaustive (the paper's evaluation protocol) -------------------------

    def run_config(self, cfg: Configuration) -> ConfigRecord:
        # measure the configuration as passed (it need not belong to the
        # study — legacy callers probe ad-hoc configs)
        point = ConfigPoint(name=cfg.name, params=cfg.params,
                            payload=cfg.make_program)
        return measure_config(self._run, point, self.policy,
                              trials=self.trials)

    def tune(self) -> StudyReport:
        records, _ = exhaustive(self._run, self.space, self.policy,
                                trials=self.trials)
        return StudyReport(
            study=self.study.name, policy=self.policy.name,
            tolerance=self.policy.tolerance, records=records,
            full_tuning_time=sum(r.full_cost for r in records),
            selective_tuning_time=sum(r.selective_cost for r in records))

    # -- racing search (beyond-paper) ------------------------------------------

    def tune_racing(self, *, max_rounds: int = 6,
                    min_survivor_trials: int = 2) -> "RacingReport":
        records, extra = racing(self._run, self.space, self.policy,
                                max_rounds=max_rounds,
                                min_survivor_trials=min_survivor_trials)
        return RacingReport(
            study=self.study.name, policy=self.policy.name,
            tolerance=self.policy.tolerance, best=extra["best"],
            cost=extra["cost"],
            samples={r.name: r.predictions for r in records},
            pruned_at=extra["pruned_at"], survivors=extra["survivors"])


@dataclass
class RacingReport:
    study: str
    policy: str
    tolerance: float
    best: str
    cost: float
    samples: Dict[str, List[float]]
    pruned_at: Dict[str, int]
    survivors: List[str]

    @property
    def total_iterations(self) -> int:
        return sum(len(v) for v in self.samples.values())
