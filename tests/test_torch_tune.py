"""The port's wall-clock tuning loop against the JAX package's, on the CPU
(smollm-135m reduced: d_model 64, 4/2 heads of 8, 2 layers, vocab 256).

(d) for every point of ``lm_config_space`` the port's ``kernel_sequence``
    gives the JAX study's signatures (field by field) and occurrence counts
    in the same order;
(e) under a deterministic tick clock (each reading advances time by a fixed
    step, so every timed thunk measures the same), both packages'
    ``session(policy="eager", trials=2, max_configs=4)`` and ``race`` pick
    the same winner with the same per-configuration records: the
    selective-execution machinery is the same code on the same kernel
    stream.  This is ``tests/test_daemon.py``'s offline-session pattern.
"""

import dataclasses

import pytest
import torch

from repro.tune.lm_study import LMStudy as JaxStudy
from repro.tune.lm_study import lm_config_space as jax_space
from repro_torch.configs import get_config
from repro_torch.core.signatures import Signature
from repro_torch.tune import LMStudy, lm_config_space

ARCH = "smollm-135m"


class TickClock:
    """Every reading advances time by ``dt``."""

    def __init__(self, dt: float = 1e-3):
        self.dt, self.now = dt, 0.0

    def __call__(self) -> float:
        self.now += self.dt
        return self.now


@pytest.fixture(scope="module")
def studies():
    return (JaxStudy(ARCH, batch=2, seq=32),
            LMStudy(ARCH, batch=2, seq=32, device="cpu"))


def test_config_space_matches_jax(studies):
    js, ts = studies
    assert [dataclasses.asdict(k) for k in lm_config_space(ts.cfg)] == \
        [dataclasses.asdict(k) for k in jax_space(js.cfg)]
    assert len(lm_config_space(ts.cfg)) == 12


@pytest.mark.parametrize("index", range(12))
def test_kernel_sequence_matches_jax(studies, index):
    js, ts = studies
    jkn = jax_space(js.cfg)[index]
    tkn = lm_config_space(ts.cfg)[index]
    jseq, tseq = js.kernel_sequence(jkn), ts.kernel_sequence(tkn)
    assert len(tseq) == len(jseq)
    for (tsig, _, tfreq), (jsig, _, jfreq) in zip(tseq, jseq):
        assert isinstance(tsig, Signature)
        assert (tsig.kind, tsig.name, tsig.params) == \
            (jsig.kind, jsig.name, jsig.params)
        assert tfreq == jfreq


def _records(result):
    return [r.to_json() for r in result.records]


def test_eager_session_picks_jax_winner_under_tick_clock(studies):
    js, ts = studies
    kw = dict(policy="eager", trials=2, max_configs=4)
    jr = js.session(clock=TickClock(), **kw).run()
    tr = ts.session(clock=TickClock(), **kw).run()
    assert tr.chosen.name == jr.chosen.name
    assert _records(tr) == _records(jr)
    assert tr.full_tuning_time == jr.full_tuning_time
    assert tr.selective_tuning_time == jr.selective_tuning_time


def test_race_picks_jax_winner_under_tick_clock(studies):
    js, ts = studies
    kw = dict(policy="conditional", max_configs=4, max_rounds=3)
    jr = js.race(clock=TickClock(), **kw)
    tr = ts.race(clock=TickClock(), **kw)
    assert tr.extra["best"] == jr.extra["best"]
    assert _records(tr) == _records(jr)


def test_study_wants_the_card_and_the_dense_family():
    """The study wants the card unless asked for the CPU, and runs every
    family: the SSM ones (``tests/test_torch_ssm_study.py``) and the
    frontend stubs (``tests/test_torch_frontends.py``) too."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMStudy(ARCH)
    names = {s.name for s, _, _ in LMStudy("xlstm-125m", device="cpu")
             .kernel_sequence(lm_config_space(get_config(
                 "xlstm-125m", reduced=True))[0])}
    assert names == {"mlstm_fb", "slstm_fb", "embed_loss_fb", "adamw"}
    full = LMStudy.__init__.__kwdefaults__
    assert full["reduced"] is True and full["device"] is None
