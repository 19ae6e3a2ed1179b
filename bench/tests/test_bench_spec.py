"""Configurations refused where the harness does not build them, the
arrival laws, and the residual branches' initial scale."""

import json
import math

import numpy as np
import pytest
import torch

from bench.harness import traffic as TR, weights
from bench.harness.cli import runner
from bench.spec import model_spec
from bench.tests.tiny import BENCH, MOE


@pytest.mark.parametrize("change", [
    {"kv_lora_rank": 512},                      # latent attention
    {"ssm_state_size": 16},                     # a scan
    {"run": dict(MOE["run"], layer_pattern="attn,mamba")},
    {"model_type": "deepseek_v2"},
    {"hidden_act": "gelu"}])
def test_a_configuration_the_harness_does_not_build_is_refused(change):
    cfg = dict(MOE, **change)
    with pytest.raises(ValueError, match="harness does not build|not built"):
        model_spec(cfg)


@pytest.mark.parametrize("name", ["phi3.5-moe-1L", "phi3.5-moe-8L",
                                  "smollm-135m"])
def test_the_benchmarks_configurations_are_built(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert model_spec(cfg).name == name


def test_a_traffic_kind_without_a_runner_is_refused():
    with pytest.raises((ImportError, ValueError)):
        runner("no_such_kind")


def test_every_seed_deals_the_same_gaps_at_the_stated_rate():
    law = {"dist": "exponential", "rate": 5.0, "strata": 32}
    got = []
    for seed in (1, 2**31 + 5):
        a = TR.Arrivals(law, seed)
        got.append([a.next() for _ in range(64)])
    for g in got:
        # each run of 32 arrivals is the whole set, whose mean gap is 1/rate
        for block in (g[:32], g[32:]):
            assert sorted(block) == pytest.approx(sorted(TR.gaps(law)))
            assert np.mean(block) == pytest.approx(0.2)
    assert got[0] != got[1]
    # exponential: the largest gap is the set's quantile 63/64
    assert max(got[0]) == pytest.approx(
        -math.log(1 / 64) / 5.0 * 0.2 / np.mean(
            -np.log1p(-(np.arange(32) + 0.5) / 32) / 5.0))


def test_a_law_from_a_new_file_alone(tmp_path):
    (tmp_path / "bench" / "traffic").mkdir(parents=True)
    (tmp_path / "bench" / "traffic" / "pareto.py").write_text(
        "def quantiles(q, law):\n"
        "    return (1 - q) ** (-1 / law['shape'])\n")
    law = {"dist": "pareto", "shape": 1.5, "rate": 2.0, "strata": 16}
    g = TR.gaps(law, tmp_path)
    assert len(g) == 16 and np.mean(g) == pytest.approx(0.5)
    assert g == sorted(g)
    with pytest.raises(ValueError, match="unknown distribution"):
        TR.gaps(dict(law, dist="nothing"), tmp_path)


def test_the_residual_branches_scale():
    spec = model_spec(dict(MOE, run=dict(MOE["run"],
                                         residual_init_scale=0.25)))
    base = weights.layout(model_spec(MOE))["pos0"]
    got = weights.layout(spec)["pos0"]
    for k, (shape, std) in got.items():
        want = base[k][1] * (0.25 if k in ("mix_wo", "ffn_w_down") else 1)
        assert std == pytest.approx(want), k
    w = weights.draw(spec, 3, "pos0", "ffn_w_down", torch.device("cpu"))
    assert float(w.std()) == pytest.approx(0.25 / math.sqrt(48), rel=0.05)
