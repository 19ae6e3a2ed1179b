"""The port's serving engine against the JAX engine on shared weights
(smollm-135m reduced, CPU), and the port's serve driver."""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel, ModelKnobs as JaxKnobs
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                      bucket_length)


@pytest.fixture(scope="module")
def engines():
    """Factories of a JAX and a port engine over the same weights."""
    jcfg = jax_get_config("smollm-135m", reduced=True)
    jmodel = JaxModel(jcfg, JaxKnobs(kv_chunk=16, ssm_chunk=8))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-135m", reduced=True)
    model = Model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")

    def make(**kw):
        return (JaxEngine(jmodel, jparams, JaxServeConfig(**kw)),
                Engine(model, params, ServeConfig(**kw)))
    return make


def _tokens(results):
    return {uid: r.tokens for uid, r in results.items()}


def test_engine_greedy_tokens_equal_jax(engines):
    jeng, eng = engines(batch_size=2, s_max=64, max_new_tokens=5)
    prompt = np.arange(7, dtype=np.int32) % 256
    jeng.submit(JaxRequest(0, prompt))
    eng.submit(Request(0, prompt))
    want, got = _tokens(jeng.run()), _tokens(eng.run())
    assert len(got[0]) == 5
    assert got == want


def test_engine_multi_request_slots_equal_jax(engines):
    """5 requests over 2 slots: queueing, retire/refill and the ragged
    decode batch give the JAX engine's tokens."""
    jeng, eng = engines(batch_size=2, s_max=64, max_new_tokens=4)
    for uid in range(5):
        prompt = np.arange(3 + uid, dtype=np.int32) % 256
        jeng.submit(JaxRequest(uid, prompt))
        eng.submit(Request(uid, prompt))
    want, got = _tokens(jeng.run()), _tokens(eng.run())
    assert len(got) == 5 and all(len(t) == 4 for t in got.values())
    assert got == want
    assert len(eng.timings["prefill_s"]) == 5
    assert len(eng.timings["decode_s"]) > 0


def test_engine_prompt_buckets_equal_jax(engines):
    """Right-padded prompts: pad K/V stay in the cache behind the mask."""
    jeng, eng = engines(batch_size=2, s_max=64, max_new_tokens=4,
                        prompt_buckets=(8, 16))
    for uid, n in enumerate((5, 11, 3)):
        prompt = (np.arange(n, dtype=np.int32) * 7 + uid) % 256
        jeng.submit(JaxRequest(uid, prompt))
        eng.submit(Request(uid, prompt))
    assert _tokens(eng.run()) == _tokens(jeng.run())


def test_bucket_length():
    assert bucket_length(5, ()) == 5
    assert bucket_length(5, (8, 16)) == 8
    assert bucket_length(9, (8, 16)) == 16
    assert bucket_length(40, (8, 16)) == 16


def test_serve_main_cpu(capsys):
    eng = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--batch", "2"])
    assert sorted(eng.results) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in eng.results.values())
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "ms/step" in out


def test_serve_main_daemon_is_a_clear_error(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "smollm-135m", "--daemon", "--device", "cpu"])
    assert "not ported" in capsys.readouterr().err
