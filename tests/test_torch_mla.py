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
- the serve CLI;
- the backward at dk != dv: the plain flash backward at (24, 16) and
  (192, 128) with MLA's scale against ``jax.grad`` of ``chunked_attention``
  and autograd of the plain forward, a recorded ``ops.flash_attention``
  and ``mla_block`` against autograd of the plain forward, and the study:
  ``LMStudy("deepseek-v2")``'s 24 points carry the JAX study's signatures
  and counts, and its ``mla_fb`` gradients match ``jax.grad`` of the JAX
  study's closure at kv 16/64 x remat none/full (atol 1e-5 times each
  tensor's largest magnitude, as ``tests/test_torch_grads.py``).

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
from repro.tune import lm_study as jax_lm_study
from repro.tune.lm_study import LMStudy as JaxStudy
from repro.tune.lm_study import StepKnobs as JaxStepKnobs
from repro.tune.lm_study import lm_config_space as jax_space
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, check_supported
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.tune import LMStudy, StepKnobs, lm_config_space

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
    # any period of the port's mixers and FFNs runs (MLA with a dense FFN
    # too, and under a frontend stub); a kind outside them does not
    check_supported(replace(cfg, ffn_pattern=("dense",)))
    check_supported(replace(cfg, n_patches=8))
    with pytest.raises(NotImplementedError, match="mla"):
        check_supported(replace(cfg, pattern=("mla", "rwkv"),
                                ffn_pattern=("moe", "moe")))


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


@pytest.fixture(scope="module")
def studies():
    """(JAX study, port study) of reduced deepseek-v2 on the shared tree
    (the JAX study is built on it, not on a draw of its own)."""
    jcfg, cfg = _configs()
    tree = _shared_tree(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lm_study, "init_params",
                   lambda cfg, key: jax.tree.map(jnp.asarray, tree))
        js = JaxStudy(ARCH, batch=2, seq=32)
    ts = LMStudy(ARCH, batch=2, seq=32, device="cpu")
    ts.params = params_from_jax(tree, cfg, device="cpu")
    return js, ts


def test_study_raises_until_mla_fb(studies):
    """The study constructs for deepseek-v2 on the CPU, and each of its 24
    points' kernel sequence (mla_fb and moe_fb per layer, embed_loss_fb,
    adamw) carries the JAX study's signatures and occurrence counts."""
    js, ts = studies
    space = lm_config_space(ts.cfg)
    assert len(space) == len(jax_space(js.cfg)) == 24
    for tk, jk in zip(space, jax_space(js.cfg)):
        tseq = ts.kernel_sequence(tk)
        assert [(s.kind, s.name, s.params, f) for s, _, f in tseq] == \
            [(s.kind, s.name, s.params, f)
             for s, _, f in js.kernel_sequence(jk)]
        assert {s.name for s, _, _ in tseq} == {
            "mla_fb", "moe_fb", "embed_loss_fb", "adamw"}


@pytest.mark.parametrize("kv", [16, 64])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_mla_fb_grads_match_jax(studies, kv, remat):
    """The port's mla_fb closure (the flash backward's plain version at
    (24, 16)) against ``jax.grad`` of the JAX study's, on the same layer-0
    weights and input: every mixer parameter's gradient, none zero."""
    js, ts = studies
    kn = dict(kv_chunk=kv, remat=remat)
    _, jbuild = js._mixer_kernel("mla", 0, JaxStepKnobs("k", **kn), 2)
    _, tbuild = ts._mixer_kernel("mla", 0, StepKnobs("k", **kn), 2)
    jfn, (jmix, _) = jbuild()
    tfn, (tmix, _) = tbuild()
    x = _randn(11, (2, 32, 64))
    jg = jfn(jmix, jnp.asarray(x))
    n0 = ops.plain_calls["flash_attention_bwd"]
    tg = tfn(tmix, torch.from_numpy(x))
    assert ops.plain_calls["flash_attention_bwd"] == n0 + 1
    assert set(tg) == set(jg) == {"ln", "wq_a", "q_ln", "wq_b", "wkv_a",
                                  "kv_ln", "wk_b", "wv_b", "wo"}
    for k in tg:
        want = np.asarray(jg[k])
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(want).max()) > 0.0
        _close(tg[k].reshape(want.shape), want, atol=ATOL * scale)


@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
def test_flash_bwd_ref_dk_ne_dv_matches_jax(dk, dv):
    """The plain backward at MLA's pairs with MLA's scale 1/sqrt(dk) (and
    one other) against ``jax.grad`` of the JAX model's chunked attention
    with ``softmax_scale`` (GQA, suffix queries, 3 chunks) and against
    autograd of the plain forward: dq and dk dk wide, dv dv wide."""
    from repro.models.layers import chunked_attention
    B, Sq, Skv, H, KVH = 2, 10, 24, 4, 2
    q, do = _randn(12, (B, Sq, H, dk)), _randn(13, (B, Sq, H, dv))
    k, v = _randn(14, (B, Skv, KVH, dk)), _randn(15, (B, Skv, KVH, dv))
    for scale in (1.0 / np.sqrt(dk), 0.3):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True,
                                         scale=scale)
        auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
        mine = ref.flash_attention_bwd_ref(
            tq.detach(), tk.detach(), tv.detach(), o.detach(), lse,
            torch.from_numpy(do), scale=scale)

        def jfwd(q, k, v):
            return chunked_attention(
                q, k, v, q_positions=jnp.arange(Skv - Sq, Skv),
                kv_positions=jnp.arange(Skv), causal=True, kv_chunk=8,
                softmax_scale=scale)
        _, vjp = jax.vjp(jfwd, *map(jnp.asarray, (q, k, v)))
        assert [tuple(g.shape) for g in mine] == [q.shape, k.shape, v.shape]
        for g, a, j in zip(mine, auto, vjp(jnp.asarray(do))):
            _close(g, a.numpy())
            _close(g, j, rtol=3e-4, atol=3e-4)


def test_recorded_backward_at_dk_ne_dv_raises(weights):
    """Gradients run through the flash op at dk != dv: a recorded
    ``ops.flash_attention`` at (24, 16) with MLA's scale, and an MLA block
    under autograd (its backward through ``flash_attention_bwd_ref``),
    match autograd of the plain forward on the same inputs."""
    rng = np.random.default_rng(16)
    qkv = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in ((1, 6, 4, 24), (1, 6, 2, 24), (1, 6, 2, 16))]
    do = torch.from_numpy(rng.standard_normal((1, 6, 4, 16))
                          .astype(np.float32))
    grads = []
    n0 = ops.plain_calls["flash_attention_bwd"]
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        ts = [t.clone().requires_grad_() for t in qkv]
        (fn(*ts, scale=1 / np.sqrt(24)) * do).sum().backward()
        grads.append([t.grad for t in ts])
    assert ops.plain_calls["flash_attention_bwd"] == n0 + 1
    for g, w in zip(*grads):
        _close(g, w.numpy())

    _, cfg = _configs()
    x = torch.from_numpy(_randn(8, (1, 6, 64)))
    pos = torch.arange(6)
    out = []
    for flash in (ops.flash_attention, ref.flash_attention_ref):
        mix = {k_: w.clone().requires_grad_() for k_, w in
               _layer(weights[1], "mix_").items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(L.ops, "flash_attention", lambda q, k, v, bk=None,
                       **kw: flash(q, k, v, **kw))
            h, _ = L.mla_block(mix, x, cfg, positions=pos, kv_chunk=4)
        out.append(torch.autograd.grad((h * h).sum(), list(mix.values())))
    for g, w in zip(*out):
        _close(g, w.numpy())


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


def test_flash_bwd_plan_at_mla_pairs():
    """The backward's tiles and geometry at MLA's pairs.  f32 at (192, 128)
    has no 64-key tile (244,992 bytes of staged tiles against 232,448), so
    beyond 32 keys a 64-key chunk takes 32 there, as in the forward; at
    the study's S 32 both knobs clamp to the sequence (kv16 -> 16, kv64 ->
    32) in either dtype.  f32 takes 32-row chunks and 4 x 2 score tiles
    where a width exceeds 64, bf16 4 warps of 64 rows; a split partial
    holds tile (dk + dv) floats."""
    from repro_torch.kernels.flash_attention import (
        BK_TILES, BWD_TILES_OUT, HEAD_DIM_PAIRS, bwd_scratch, bwd_tiles,
        plan_flash_bwd)
    f32, bf16 = torch.float32, torch.bfloat16
    assert BWD_TILES_OUT == ((f32, 192, 128, 64),)
    assert bwd_tiles(f32, 192, 128) == (16, 32)
    for pair in HEAD_DIM_PAIRS:
        for dt in (f32, bf16):
            if (dt, pair) != (f32, (192, 128)):
                assert bwd_tiles(dt, *pair) == BK_TILES

    def plan(S, dt, bk, dk=192, dv=128):
        q, k = torch.zeros(2, S, 4, dk, dtype=dt), \
            torch.zeros(2, S, 2, dk, dtype=dt)
        v, o = torch.zeros(2, S, 2, dv, dtype=dt), \
            torch.zeros(2, S, 4, dv, dtype=dt)
        return plan_flash_bwd(q, k, v, o, o, bk)
    for dt in (f32, bf16):
        assert [plan(32, dt, bk).tile for bk in (16, 64)] == [16, 32]
    assert (plan(70, f32, 64).tile, plan(70, bf16, 64).tile) == (32, 64)
    geo = {(dt, bk): (plan(32, dt, bk).warps, plan(32, dt, bk).rows)
           for dt in (f32, bf16) for bk in (16, 64)}
    assert geo == {(f32, 16): (2, 32), (f32, 64): (4, 32),
                   (bf16, 16): (4, 64), (bf16, 64): (4, 64)}
    red = plan(32, f32, 64, 24, 16)
    assert (red.tile, red.warps, red.rows) == (32, 4, 64)
    assert bwd_scratch(1, 2, 512, 32, 4, 192, 128) == (2 * 16 * 4 * 32 * 320,
                                                       2 * 16)
    assert bwd_scratch(1, 2, 512, 32, 1, 192, 128) == (0, 0)


@pytest.mark.parametrize("dk,dv", [(24, 24), (192, 192), (128, 64),
                                   (16, 24)])
def test_flash_wrapper_rejects_uninstantiated_pairs(dk, dv):
    """A (dk, dv) pair the kernel is not instantiated at raises before any
    launch, naming the pairs that exist."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k = torch.zeros(1, 4, 2, dk), torch.zeros(1, 4, 2, dk)
    with pytest.raises(ValueError, match=r"\(192, 128\), \(24, 16\)"):
        flash_attention_cuda(q, k, torch.zeros(1, 4, 2, dv))
