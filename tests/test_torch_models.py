"""The port's dense layers and model against the JAX package, on shared
weights (smollm-135m reduced: d_model 64, 4/2 heads, head_dim 8, d_ff 128,
vocab 256, 2 layers).

The JAX ``init_params`` tree is carried across by ``params_from_jax``; its
norm weights are replaced with random values on both sides first, because
zero norm weights make the norm's ``(1 + w)`` scale the identity and would
hide a port that scales by ``w``.  All in f32 on the CPU.  Tolerance: rtol
1e-4, atol 1e-5 -- the two sides do the same f32 arithmetic in another
order (XLA vs PyTorch CPU kernels, and the JAX side's chunked online
softmax against the port's single-pass softmax).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.model import Model as JaxModel, ModelKnobs as JaxKnobs
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, init_params

RTOL, ATOL = 1e-4, 1e-5
JAX_KNOBS = JaxKnobs(kv_chunk=16)


def shared_params(seed=0):
    """(JAX params, port params on the CPU) with the same random weights."""
    cfg = jax_get_config("smollm-135m", reduced=True)
    tree = jax.tree.map(np.asarray, JaxModel(cfg, JAX_KNOBS).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for sub in tree.values():
        for nm in sub:
            if nm.endswith("ln"):
                sub[nm] = (rng.standard_normal(sub[nm].shape) * 0.1
                           ).astype(np.float32)
    port = params_from_jax(tree, get_config("smollm-135m", reduced=True),
                           device="cpu")
    return jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-135m", reduced=True)
    cfg = get_config("smollm-135m", reduced=True)
    jp, tp = shared_params()
    return jcfg, cfg, jp, tp


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _layer0(jp, tp, prefix):
    jl = {k[len(prefix):]: v[0] for k, v in jp["pos0"].items()
          if k.startswith(prefix)}
    tl = {k[len(prefix):]: v[0] for k, v in tp["pos0"].items()
          if k.startswith(prefix)}
    return jl, tl


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_jax(reduced):
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert asdict(get_config(name, reduced)) == \
            asdict(jax_get_config(name, reduced))


def test_rms_norm(setup):
    jcfg, cfg, jp, tp = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64), np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_apply_rope(setup):
    jcfg, cfg, jp, tp = setup
    x = np.random.default_rng(2).standard_normal((2, 16, 4, 8), np.float32)
    pos = np.arange(16) + 5
    jc, js = JL.rope_tables(jnp.asarray(pos), 8, cfg.rope_theta)
    tc, ts = L.rope_tables(torch.from_numpy(pos), 8, cfg.rope_theta)
    _close(tc, jc)
    _close(ts, js)
    _close(L.apply_rope(torch.from_numpy(x), tc, ts),
           JL.apply_rope(jnp.asarray(x), jc, js))


def test_attn_block(setup):
    jcfg, cfg, jp, tp = setup
    jl, tl = _layer0(jp, tp, "mix_")
    x = np.random.default_rng(3).standard_normal((2, 24, 64), np.float32)
    pos = np.arange(24)
    jout, (jk, jv) = JL.attn_block(jl, jnp.asarray(x), jcfg,
                                   positions=jnp.asarray(pos), kv_chunk=16)
    tout, (tk, tv) = L.attn_block(tl, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos))
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


def test_attn_decode_ragged_t(setup):
    jcfg, cfg, jp, tp = setup
    jl, tl = _layer0(jp, tp, "mix_")
    rng = np.random.default_rng(4)
    B, S = 3, 16
    x = rng.standard_normal((B, 1, 64), np.float32)
    k = rng.standard_normal((B, S, 2, 8), np.float32)
    v = rng.standard_normal((B, S, 2, 8), np.float32)
    t = np.array([3, 9, 15])
    kv_pos = np.arange(S)
    jout, (jk, jv) = JL.attn_decode(jl, jnp.asarray(x),
                                    (jnp.asarray(k), jnp.asarray(v)), jcfg,
                                    t=jnp.asarray(t),
                                    kv_positions=jnp.asarray(kv_pos))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tout, (tk2, tv2) = L.attn_decode(tl, torch.from_numpy(x), (tk, tv), cfg,
                                     t=torch.from_numpy(t),
                                     kv_positions=torch.from_numpy(kv_pos))
    assert tk2 is tk and tv2 is tv          # written in place
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)


def test_ffn_block(setup):
    jcfg, cfg, jp, tp = setup
    jl, tl = _layer0(jp, tp, "ffn_")
    x = np.random.default_rng(5).standard_normal((2, 16, 64), np.float32)
    _close(L.ffn_block(tl, torch.from_numpy(x), cfg),
           JL.ffn_block(jl, jnp.asarray(x), jcfg))


def _tokens(B, S, seed=6):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_forward_logits(setup):
    jcfg, cfg, jp, tp = setup
    toks = _tokens(2, 16)
    want = JaxModel(jcfg, JAX_KNOBS).forward(jp, {"tokens": jnp.asarray(toks)})
    got = Model(cfg, device="cpu").forward(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 16, 256)
    _close(got, want)


def test_prefill_and_teacher_forced_decode(setup):
    """Prefill (right-padded rows, ``logits_at``) then 8 teacher-forced
    decode steps with ragged per-row positions: logits and cache match."""
    jcfg, cfg, jp, tp = setup
    jm, tm = JaxModel(jcfg, JAX_KNOBS), Model(cfg, device="cpu")
    toks = _tokens(2, 20)
    S_pre, s_max = 12, 32
    at = np.array([7, 11])          # row 0 is a 8-token prompt padded to 12
    jlg, jcache, jt = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S_pre])},
                                 s_max, logits_at=jnp.asarray(at))
    tlg, tcache, tt = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :S_pre])}, s_max, logits_at=torch.from_numpy(at))
    assert tt == jt == S_pre
    _close(tlg, jlg)
    for a, b in zip(tcache[0], jcache[0]):
        assert tuple(a.shape) == b.shape == (2, 2, s_max, 2, 8)
        _close(a, b)
    t = at + 1                      # each row continues from its own end
    for i in range(8):
        tok = toks[np.arange(2), np.minimum(t, 19)][:, None]
        jlg, jcache = jm.decode_step(jp, jcache, jnp.asarray(t, jnp.int32),
                                     {"tokens": jnp.asarray(tok)})
        tlg, tcache = tm.decode_step(tp, tcache, torch.from_numpy(t),
                                     {"tokens": torch.from_numpy(tok)})
        _close(tlg, jlg)
        t = t + 1
    for a, b in zip(tcache[0], jcache[0]):
        _close(a, b)


def test_prefill_decode_matches_forward():
    """Port alone (test_models.py's check): teacher-forced decode after
    prefill reproduces the full-sequence forward logits."""
    cfg = get_config("smollm-135m", reduced=True)
    model = Model(cfg, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S, S_pre = 2, 16, 8
    toks = torch.from_numpy(_tokens(B, S, seed=2))
    full = model.forward(params, {"tokens": toks})
    lg, cache, _ = model.prefill(params, {"tokens": toks[:, :S_pre]}, S)
    _close(lg, full[:, S_pre - 1], rtol=2e-2, atol=2e-3)
    for t in range(S_pre, S):
        lg, cache = model.decode_step(params, cache, t,
                                      {"tokens": toks[:, t:t + 1]})
        _close(lg, full[:, t], rtol=2e-2, atol=2e-3)


def test_init_params_is_seeded_and_device_free():
    cfg = get_config("smollm-135m", reduced=True)
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for g in a:
        for nm in a[g]:
            assert torch.equal(a[g][nm], b[g][nm])
    assert a["pos0"]["mix_wq"].shape == (2, 64, 32)
    assert float(a["pos0"]["mix_ln"].abs().max()) == 0.0
    assert abs(float(a["embed"]["tok"].std()) - 0.02) < 2e-3


def test_params_from_jax_checks_shapes(setup):
    jcfg, cfg, jp, tp = setup
    tree = jax.tree.map(np.asarray, jp)
    tree["pos0"]["mix_wq"] = tree["pos0"]["mix_wq"][:, :, :3]
    with pytest.raises(ValueError, match="mix_wq"):
        params_from_jax(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    del tree["final"]
    with pytest.raises(ValueError, match="groups"):
        params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-125m", "phi3.5-moe",
                                  "deepseek-v2", "musicgen-large"])
def test_non_dense_archs_not_implemented(arch):
    with pytest.raises(NotImplementedError):
        Model(get_config(arch, reduced=True), device="cpu")
