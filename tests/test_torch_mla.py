"""The port's MLA layers and deepseek-v2 against the JAX package, on shared
weights (deepseek-v2 reduced: d_model 64, 4 heads, MLA kv_lora 32, q_lora
48, d_rope 8, d_nope 16, d_v 16, so (dk, dv) = (24, 16); 4 experts of d_ff
64 with top-2 routing and one shared expert, vocab 256, 2 layers; CPU,
f32).

The JAX ``init_params`` tree is carried across by ``params_from_jax``
with its norm weights randomized (``ln``, ``q_ln``, ``kv_ln``, ``ffn_ln``
and the final norm: zeros would hide a port that scales by ``w``), and
with ``wq_b``, ``wk_b`` and ``wv_b`` drawn from their fan-ins: the JAX
init zeroes every name ending in ``_b``, which would make every MLA block
output zero.  Inputs are made with numpy from a seed and given to both
sides; the JAX side runs under ``jax.jit``.

- ``mla_project_q``, ``mla_block`` (output and latent cache) and the
  absorbed ``mla_decode`` (output and the cache written at ragged
  positions);
- the plain flash version at dk != dv and with a ``scale``, against
  ``chunked_attention(softmax_scale=...)``;
- the model's forward, prefill and teacher-forced decode logits, greedy
  tokens from both engines, ``params_from_jax``'s shape checks, and the
  port's prefill-then-decode against its own forward
  (``tests/test_models.py``'s consistency check);
- the serve CLI, and what stays unported raising: the study
  (``mla_fb``) and a recorded backward at dk != dv.

Tolerances as ``tests/test_torch_models.py``: rtol 1e-4, atol 1e-5 (the
same f32 arithmetic in another order).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.model import Model as JaxModel, ModelKnobs as JaxKnobs
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, check_supported
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.tune import LMStudy

RTOL, ATOL = 1e-4, 1e-5
ARCH = "deepseek-v2"
# the JAX init's zeroed up-projections (names ending in "_b")
UP_PROJ = ("mix_wq_b", "mix_wk_b", "mix_wv_b")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _configs(**moe):
    """(JAX config, port config) of reduced deepseek-v2."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(ARCH, reduced=True)
        out.append(replace(cfg, moe=replace(cfg.moe, **moe)) if moe else cfg)
    return tuple(out)


_TREES = {}


def _shared_tree(jcfg, seed=0):
    """A copy of the JAX init tree as numpy: norms randomized, the zeroed
    up-projections drawn N(0, 1/fan_in) (fan_in: the latent's width)."""
    if (jcfg, seed) not in _TREES:
        tree = jax.tree.map(np.asarray, jax.jit(JaxModel(jcfg).init)(
            jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed)
        for sub in tree.values():
            for nm, a in sub.items():
                if nm.endswith("ln"):
                    sub[nm] = (rng.standard_normal(a.shape) * 0.1
                               ).astype(np.float32)
                elif nm in UP_PROJ:
                    assert not a.any()
                    sub[nm] = (rng.standard_normal(a.shape)
                               / np.sqrt(a.shape[1])).astype(np.float32)
        _TREES[jcfg, seed] = tree
    return jax.tree.map(np.copy, _TREES[jcfg, seed])


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) on the same weights."""
    jcfg, cfg = _configs()
    tree = _shared_tree(jcfg)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"))


def _layer(params, prefix, i=0):
    return {k[len(prefix):]: v[i] for k, v in params["pos0"].items()
            if k.startswith(prefix)}


def _randn(seed, shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std) \
        .astype(np.float32)


def test_config_is_mla_with_moe():
    _, cfg = _configs()
    m = cfg.mla
    assert cfg.pattern == ("mla",) and cfg.ffn_pattern == ("moe",)
    assert (m.d_nope + m.d_rope, m.d_v) == (24, 16)
    full = get_config(ARCH)
    assert (full.mla.d_nope + full.mla.d_rope, full.mla.d_v) == (192, 128)
    check_supported(cfg)
    Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mla"):
        check_supported(replace(cfg, ffn_pattern=("dense",)))


def test_mla_project_q_matches_jax(weights):
    jcfg, cfg = _configs()
    jp, tp = (_layer(w, "mix_") for w in weights)
    h = _randn(0, (2, 7, 64))
    want = jax.jit(JL.mla_project_q, static_argnums=2)(jp, jnp.asarray(h),
                                                      jcfg)
    got = L.mla_project_q(tp, torch.from_numpy(h), cfg)
    assert got.shape == (2, 7, 4, 24)
    _close(got, want)


@pytest.mark.parametrize("kv_chunk", [4, 16])
def test_mla_block_matches_jax(weights, kv_chunk):
    """Output and latent cache; JAX expands K/V a chunk at a time (4: four
    chunks of the 16 positions), the port once through the flash
    kernel's plain version at (24, 16)."""
    jcfg, cfg = _configs()
    jp, tp = (_layer(w, "mix_") for w in weights)
    x = _randn(1, (2, 16, 64))
    pos = np.arange(16)
    jblock = jax.jit(JL.mla_block, static_argnames=("cfg", "kv_chunk"))
    want, (jckv, jkr) = jblock(jp, jnp.asarray(x), cfg=jcfg,
                               positions=jnp.asarray(pos), kv_chunk=kv_chunk)
    n0 = ops.plain_calls["flash_attention"]
    got, (ckv, kr) = L.mla_block(tp, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos))
    assert ops.plain_calls["flash_attention"] == n0 + 1
    assert got.shape == (2, 16, 64)
    assert ckv.shape == (2, 16, 32) and kr.shape == (2, 16, 8)
    _close(got, want)
    _close(ckv, jckv)
    _close(kr, jkr)


def test_mla_decode_matches_jax(weights):
    """The absorbed decode against a filled latent cache at ragged
    positions: the output, and the cache written at t (2H matmul calls,
    one a head for q_lat and for o)."""
    jcfg, cfg = _configs()
    jp, tp = (_layer(w, "mix_") for w in weights)
    B, S = 2, 16
    x = _randn(2, (B, 1, 64))
    ckv, kr = _randn(3, (B, S, 32)), _randn(4, (B, S, 8))
    t = np.array([5, 11])
    jdec = jax.jit(JL.mla_decode, static_argnames="cfg")
    want, (jckv, jkr) = jdec(jp, jnp.asarray(x),
                             (jnp.asarray(ckv), jnp.asarray(kr)), cfg=jcfg,
                             t=jnp.asarray(t), kv_positions=jnp.arange(S))
    n0 = ops.plain_calls["matmul"]
    got, (tckv, tkr) = L.mla_decode(
        tp, torch.from_numpy(x),
        (torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())), cfg,
        t=torch.from_numpy(t), kv_positions=torch.arange(S))
    # wq_a, wq_b, wkv_a, 2 x 4 heads, wo
    assert ops.plain_calls["matmul"] == n0 + 4 + 2 * cfg.n_heads
    assert got.shape == (B, 1, 64)
    _close(got, want)
    _close(tckv, jckv)
    _close(tkr, jkr)


@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128), (16, 16)])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_ref_dk_ne_dv_matches_chunked_attention(dk, dv, scale):
    """The plain flash version at a (dk, dv) pair and a scale against the
    JAX model's chunked attention with ``softmax_scale`` (GQA, 3 chunks of
    8)."""
    from repro.models.layers import chunked_attention
    B, S, H, KVH = 2, 24, 4, 2
    q, k = _randn(5, (B, S, H, dk)), _randn(6, (B, S, KVH, dk))
    v = _randn(7, (B, S, KVH, dv))
    pos = jnp.arange(S)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=pos, kv_positions=pos, causal=True,
                             kv_chunk=8, softmax_scale=scale)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=scale)
    assert got.shape == (B, S, H, dv)
    _close(got, want, rtol=3e-4, atol=3e-4)


def _tokens(B, S, seed=6):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_forward_logits_match_jax(weights):
    jcfg, cfg = _configs()
    jp, tp = weights
    toks = _tokens(2, 16)
    jm = JaxModel(jcfg, JaxKnobs(kv_chunk=8))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = Model(cfg, device="cpu").forward(tp, {"tokens":
                                               torch.from_numpy(toks)})
    assert got.shape == (2, 16, 256)
    _close(got, want)


def test_prefill_and_teacher_forced_decode_match_jax(weights):
    """Prefill (right-padded rows, ``logits_at``) then 6 teacher-forced
    decode steps of 2 rows at ragged positions; the latent caches equal."""
    jcfg, cfg = _configs()
    jp, tp = weights
    jm = JaxModel(jcfg, JaxKnobs(kv_chunk=12))
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    tm = Model(cfg, device="cpu")
    toks = _tokens(2, 20)
    S_pre, s_max = 12, 32
    at = np.array([7, 11])
    jlg, jcache, _ = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S_pre])},
                              s_max, logits_at=jnp.asarray(at))
    tlg, tcache, _ = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :S_pre])}, s_max, logits_at=torch.from_numpy(at))
    assert tcache[0][0].shape == (2, 2, s_max, 32)
    assert tcache[0][1].shape == (2, 2, s_max, 8)
    _close(tlg, jlg)
    t = at + 1
    for _ in range(6):
        tok = toks[np.arange(2), np.minimum(t, 19)][:, None]
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(t, jnp.int32),
                              {"tokens": jnp.asarray(tok)})
        tlg, tcache = tm.decode_step(tp, tcache, torch.from_numpy(t),
                                     {"tokens": torch.from_numpy(tok)})
        _close(tlg, jlg)
        t = t + 1
    for a, b in zip(tcache[0], jcache[0]):
        _close(a, b)


def test_engine_greedy_tokens_equal_jax(weights):
    """4 requests over 2 slots: prefill, the latent-cache splice, retire
    and refill, and the ragged absorbed decode give the JAX engine's
    tokens."""
    jcfg, cfg = _configs()
    jp, tp = weights
    kw = dict(batch_size=2, s_max=64, max_new_tokens=5)
    jeng = JaxEngine(JaxModel(jcfg, JaxKnobs(kv_chunk=16)), jp,
                     JaxServeConfig(**kw))
    eng = Engine(Model(cfg, device="cpu"), tp, ServeConfig(**kw))
    for uid in range(4):
        prompt = (np.arange(4 + 3 * uid, dtype=np.int32) * 5 + uid) % 256
        jeng.submit(JaxRequest(uid, prompt))
        eng.submit(Request(uid, prompt))
    want = {u: r.tokens for u, r in jeng.run().items()}
    got = {u: r.tokens for u, r in eng.run().items()}
    assert len(got) == 4 and all(len(t) == 5 for t in got.values())
    assert got == want


def test_params_from_jax_checks_mla_shapes():
    jcfg, cfg = _configs()
    tree = _shared_tree(jcfg)
    port = params_from_jax(tree, cfg, device="cpu")["pos0"]
    m, H = cfg.mla, cfg.n_heads
    assert port["mix_wq_b"].shape == (2, 48, H * 24)
    assert port["mix_wk_b"].shape == (2, 32, H * 16)
    assert port["mix_wv_b"].shape == (2, 32, H * m.d_v)
    assert port["mix_wo"].shape == (2, H * m.d_v, 64)
    np.testing.assert_array_equal(
        port["mix_wk_b"].numpy(), tree["pos0"]["mix_wk_b"].reshape(2, 32, -1))
    for nm, cut in (("mix_wk_b", np.s_[:, :, :3]), ("mix_wo", np.s_[:, :3]),
                    ("mix_kv_ln", np.s_[:, :5])):
        bad = _shared_tree(jcfg)
        bad["pos0"][nm] = bad["pos0"][nm][cut]
        with pytest.raises(ValueError, match=nm):
            params_from_jax(bad, cfg, device="cpu")
    # an attention tree is not an MLA tree
    bad = _shared_tree(jcfg)
    bad["pos0"]["mix_wq"] = bad["pos0"].pop("mix_wq_a")
    with pytest.raises(ValueError, match="pos0"):
        params_from_jax(bad, cfg, device="cpu")


def test_prefill_decode_matches_forward():
    """Teacher-forced decode after prefill reproduces the port's own
    full-sequence forward (``tests/test_models.py``'s check for the JAX
    package): the latent cache and the absorbed decode against the
    expanded prefill.  Capacity drops killed, as there, since they
    legitimately differ between prompt lengths."""
    _, cfg = _configs(capacity_factor=64.0)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    for nm in UP_PROJ + ("mix_q_ln", "mix_kv_ln", "mix_ln"):
        w = params["pos0"][nm]
        params["pos0"][nm] = torch.from_numpy(_randn(
            9, tuple(w.shape), 0.1 if nm.endswith("ln")
            else 1 / np.sqrt(w.shape[1])))
    B, S, S_pre = 2, 16, 8
    toks = torch.from_numpy(_tokens(B, S, seed=2))
    full = model.forward(params, {"tokens": toks})
    lg, cache, t0 = model.prefill(params, {"tokens": toks[:, :S_pre]}, S)
    assert t0 == S_pre
    _close(lg, full[:, S_pre - 1].numpy())
    for t in range(S_pre, S):
        lg, cache = model.decode_step(params, cache, t,
                                      {"tokens": toks[:, t:t + 1]})
        _close(lg, full[:, t].numpy())


def test_serve_main_cpu(capsys):
    eng = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--batch", "2"])
    assert sorted(eng.results) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in eng.results.values())
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_study_raises_until_mla_fb():
    with pytest.raises(NotImplementedError, match="mla_fb"):
        LMStudy(ARCH, device="cpu")


def test_recorded_backward_at_dk_ne_dv_raises(weights):
    """No gradient through the flash kernels at dk != dv yet: the op and
    an MLA block under autograd raise before anything runs; without
    gradients the same call serves."""
    q = torch.randn(1, 4, 2, 24, requires_grad=True)
    k, v = torch.randn(1, 4, 2, 24), torch.randn(1, 4, 2, 16)
    n0 = ops.plain_calls["flash_attention"]
    with pytest.raises(NotImplementedError, match="mla_fb"):
        ops.flash_attention(q, k, v)
    assert ops.plain_calls["flash_attention"] == n0
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == (1, 4, 2, 16)
    _, cfg = _configs()
    mix = {k_: w.clone().requires_grad_() for k_, w in
           _layer(weights[1], "mix_").items()}
    x = torch.from_numpy(_randn(8, (1, 6, 64)))
    with pytest.raises(NotImplementedError, match="dk != dv"):
        L.mla_block(mix, x, cfg, positions=torch.arange(6))


def test_scale_reaches_the_backward_at_dk_eq_dv():
    """At dk = dv a non-default scale is carried to the backward: the
    op's gradients equal autograd's through the plain forward."""
    rng = np.random.default_rng(10)
    qkv = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))]
    do = torch.from_numpy(rng.standard_normal((2, 8, 4, 16))
                          .astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: ops.flash_attention(q, k, v, scale=0.3),
               lambda q, k, v: ref.flash_attention_ref(q, k, v, scale=0.3)):
        ts = [t.clone().requires_grad_() for t in qkv]
        (fn(*ts) * do).sum().backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        _close(g, w.numpy())


# -- the flash kernel's plan at the MLA pairs (plain Python) -----------------

def test_flash_pairs_and_tiles():
    """The forward is instantiated at MLA's pairs; at (192, 128) f32 the
    64-key tile's staged tiles exceed a block's shared memory (234,496 of
    232,448 bytes), so the plan never asks for it: a 64-key chunk takes
    32 there, and every other pair keeps every tile."""
    from repro_torch.kernels.flash_attention import (
        BK_TILES, FWD_TILES_OUT, HEAD_DIM_PAIRS, fwd_tiles, kv_tile,
        plan_flash)
    f32, bf16 = torch.float32, torch.bfloat16
    assert (192, 128) in HEAD_DIM_PAIRS and (24, 16) in HEAD_DIM_PAIRS
    assert FWD_TILES_OUT == ((f32, 192, 128, 64),)
    assert fwd_tiles(f32, 192, 128) == (16, 32)
    for pair in HEAD_DIM_PAIRS:
        for dt in (f32, bf16):
            if (dt, pair) != (f32, (192, 128)):
                assert fwd_tiles(dt, *pair) == BK_TILES
    tiles = fwd_tiles(f32, 192, 128)
    assert [kv_tile(bk, 2048, f32, tiles) for bk in (None, 16, 17, 64)] \
        == [32, 16, 32, 32]
    q, k = torch.zeros(1, 128, 128, 192), torch.zeros(1, 128, 128, 192)
    v = torch.zeros(1, 128, 128, 128)
    assert plan_flash(q, k, v, 64).bk == 32
    assert plan_flash(q.bfloat16(), k.bfloat16(), v.bfloat16(), 64).bk == 64
    # deepseek-v2's prefill: 128 heads over 128 KV heads (G 1), one block
    # a head of up to 64 positions
    plan = plan_flash(q[:, :31], k[:, :31], v[:, :31])
    assert (plan.gh, plan.bq, plan.bk, plan.grid) == (1, 64, 32, (1, 128, 1))


@pytest.mark.parametrize("dk,dv", [(24, 24), (192, 192), (128, 64),
                                   (16, 24)])
def test_flash_wrapper_rejects_uninstantiated_pairs(dk, dv):
    """A (dk, dv) pair the kernel is not instantiated at raises before any
    launch, naming the pairs that exist."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k = torch.zeros(1, 4, 2, dk), torch.zeros(1, 4, 2, dk)
    with pytest.raises(ValueError, match=r"\(192, 128\), \(24, 16\)"):
        flash_attention_cuda(q, k, torch.zeros(1, 4, 2, dv))
