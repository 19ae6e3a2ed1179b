"""The port's recurrent mixers (``models/ssm.py``), its periodic layer
stacks and the SSM families against the JAX package, on shared weights
(CPU, f32).

Reduced configurations: xlstm-125m (d_model 64, 4 heads, d_inner 128, so
mLSTM heads of 32 and sLSTM heads of 16; period 2, mLSTM then sLSTM, FFN
``none``; 4 layers) and jamba (d_model 64, 4/2 attention heads of 8,
d_inner 128, d_state 4, dt rank 8; period 8: Mamba everywhere but
attention at position 4, dense FFNs at even positions and 4 experts of 64
with top-2 at odd ones; 16 layers).  The JAX ``init_params`` tree is
carried across by ``params_from_jax`` with its norm weights and its zero
biases (``b_if``, sLSTM's ``b``) randomized: zeros would hide a port that
scales by ``w`` or drops a bias.  Inputs are made with numpy from a seed
and given to both sides.

- ``causal_conv`` with and without a carried state; ``mamba_block``,
  ``mlstm_block`` (chunkwise at chunk 5, 8 and 16, and recurrent) and
  ``slstm_block`` at S 12 and 16, from zero and from a carried state:
  outputs and every state leaf;
- the port's chunkwise mLSTM against its recurrent form
  (``tests/test_models.py``'s check), and ``chunked_scan``'s refusal of a
  length that is not a whole number of chunks, in both packages;
- both models' forward, prefill (every cache leaf) and 4 teacher-forced
  decode steps at ragged positions; the engines' greedy tokens, with and
  without ``prompt_buckets`` (under buckets an SSM's state has run over
  the pad tokens, in both packages); ``params_from_jax`` over
  ``pos0``-``pos7``; the SSM init values; and the serve CLI (the study:
  ``tests/test_torch_ssm_study.py``).

Tolerances as ``tests/test_torch_models.py``: rtol 1e-4, atol 1e-5 (the
same f32 arithmetic in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as JS
from repro.models.model import Model as JaxModel, ModelKnobs as JaxKnobs
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (Model, ModelKnobs, init_params,
                                      spec_tree)
from repro_torch.serve.engine import Engine, Request, ServeConfig

RTOL, ATOL = 1e-4, 1e-5
XLSTM, JAMBA = "xlstm-125m", "jamba-v0.1-52b"
# S 12 and 16 are whole numbers of chunks of 4, and within one chunk of 16
CHUNK = 4


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_trees(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def _configs(arch):
    return jax_get_config(arch, reduced=True), get_config(arch, reduced=True)


_INITS = {}


def _jax_init(arch, seed=0):
    """The JAX init tree of the reduced ``arch`` as numpy (a copy).  The key
    is an ``rbg`` one: the same init, drawn by a generator whose jitted
    draws of jamba's ~100 leaves compile in about half the time of the
    default threefry's."""
    if (arch, seed) not in _INITS:
        jcfg, _ = _configs(arch)
        _INITS[arch, seed] = jax.tree.map(np.asarray, jax.jit(
            JaxModel(jcfg).init)(jax.random.key(seed, impl="rbg")))
    return jax.tree.map(np.copy, _INITS[arch, seed])


def _shared_tree(arch, seed=0):
    """The JAX init tree, norms and zero biases drawn, and the MoE experts'
    down-projections scaled by 0.1.  The reference's MoE FFN reads the
    un-normalized residual, so with drawn weights each MoE layer roughly
    squares its scale: reduced jamba's residual reaches ~7e9 by layer 16,
    where both packages still agree to ~1e-9 of it, layer by layer, but
    the logits are then no test of the f32 arithmetic.  Scaled, the
    residual stays under 10."""
    tree = _jax_init(arch, seed)
    rng = np.random.default_rng(seed)
    for g, sub in tree.items():
        for nm, a in sub.items():
            if nm.endswith(("ln", "b_if", "mix_b")):
                assert not a.any()
                sub[nm] = (rng.standard_normal(a.shape) * 0.1
                           ).astype(np.float32)
            elif nm == "ffn_w_down" and "ffn_router" in sub:
                sub[nm] = a * np.float32(0.1)
    return tree


@pytest.fixture(scope="module", params=[XLSTM, JAMBA])
def weights(request):
    """(arch, JAX params, port params) on the same weights."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    tree = _shared_tree(arch)
    return (arch, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"))


def _randn(seed, shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std) \
        .astype(np.float32)


def _both(tree, pos):
    """(JAX, port) mixer weights of position ``pos``, period 0."""
    lay = {k[4:]: v[0] for k, v in tree[f"pos{pos}"].items()
           if k.startswith("mix_")}
    return ({k: jnp.asarray(v) for k, v in lay.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in lay.items()})


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the blocks ----------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    x, w = _randn(1, (2, 12, 24)), _randn(2, (4, 24), 0.5)
    st = _randn(3, (2, 3, 24)) if carried else None
    jy, jst = JS.causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    ty, tst = S.causal_conv(_t(x), _t(w), None if st is None else _t(st))
    _close(ty, jy)
    _close(tst, jst)
    # a segment's state carried into the next equals one pass over both
    y2, _ = S.causal_conv(_t(x[:, 5:]), _t(w), S.causal_conv(
        _t(x[:, :5]), _t(w), None if st is None else _t(st))[1])
    _close(y2, ty[:, 5:], rtol=1e-6, atol=1e-6)


# (S, chunk): whole chunks, and one chunk as long as the sequence
SEQ_CHUNKS = [(12, CHUNK), (16, 16)]

_CARRIED = {}


def _carried(name, jfn, tfn, jp, tp, jcfg, cfg, seed):
    """Both packages' state after an 8-token segment through ``jfn`` /
    ``tfn`` at chunk 8, once a block: the carried cases of a block share
    it, so its JAX scan compiles once."""
    if name not in _CARRIED:
        pre = _randn(seed, (2, 8, cfg.d_model))
        _CARRIED[name] = (jfn(jp, jnp.asarray(pre), jcfg, chunk=8)[1],
                          tfn(tp, _t(pre), cfg, chunk=8)[1])
    return _CARRIED[name]


@pytest.mark.parametrize("seq,chunk", SEQ_CHUNKS)
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_block_matches_jax(seq, chunk, carried):
    jcfg, cfg = _configs(JAMBA)
    jp, tp = _both(_shared_tree(JAMBA), 0)
    x = _randn(seq, (2, seq, cfg.d_model))
    kw_j, kw_t = {}, {}
    if carried:     # the state after another segment
        (jc, js), (tc, ts) = _carried("mamba", JS.mamba_block,
                                      S.mamba_block, jp, tp, jcfg, cfg, 5)
        _close(tc, jc)
        _close(ts, js)
        kw_j, kw_t = dict(conv_state=jc, ssm_state=js), \
            dict(conv_state=tc, ssm_state=ts)
    jy, jst = JS.mamba_block(jp, jnp.asarray(x), jcfg, chunk=chunk, **kw_j)
    ty, tst = S.mamba_block(tp, _t(x), cfg, chunk=chunk, **kw_t)
    _close(ty, jy)
    _close_trees(tst, jst)


MLSTM_MODES = [("chunkwise", 5), ("chunkwise", 8), ("chunkwise", 16),
               ("recurrent", CHUNK)]
# every mode at S 12 and 16 from zero; from a carried state at S 12, and
# at S 16 in one chunk and recurrent
MLSTM_CASES = ([(seq, m, c, False) for seq in (12, 16) for m, c in MLSTM_MODES]
               + [(12, m, c, True) for m, c in MLSTM_MODES]
               + [(16, "chunkwise", 16, True), (16, "recurrent", CHUNK, True)])


@pytest.mark.parametrize("seq,mode,chunk,carried", MLSTM_CASES)
def test_mlstm_block_matches_jax(seq, mode, chunk, carried):
    jcfg, cfg = _configs(XLSTM)
    jp, tp = _both(_shared_tree(XLSTM), 0)
    x = _randn(seq, (2, seq, cfg.d_model))
    kw_j, kw_t = {}, {}
    if carried:
        (jc, js), (tc, ts) = _carried("mlstm", JS.mlstm_block,
                                      S.mlstm_block, jp, tp, jcfg, cfg, 6)
        _close_trees((tc, ts), (jc, js))
        kw_j, kw_t = dict(conv_state=jc, state=js), \
            dict(conv_state=tc, state=ts)
    jy, jst = JS.mlstm_block(jp, jnp.asarray(x), jcfg, chunk=chunk,
                             mode=mode, **kw_j)
    ty, tst = S.mlstm_block(tp, _t(x), cfg, chunk=chunk, mode=mode, **kw_t)
    _close(ty, jy)
    _close_trees(tst, jst)


@pytest.mark.parametrize("seq,chunk", SEQ_CHUNKS)
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_block_matches_jax(seq, chunk, carried):
    jcfg, cfg = _configs(XLSTM)
    jp, tp = _both(_shared_tree(XLSTM), 1)
    assert tp["r"].shape == (4, 16, 64)         # nh, dh, 4 dh: kept 3-D
    x = _randn(seq, (2, seq, cfg.d_model))
    kw_j, kw_t = {}, {}
    if carried:
        js, ts = _carried("slstm", JS.slstm_block, S.slstm_block, jp, tp,
                          jcfg, cfg, 7)
        _close_trees(ts, js)
        kw_j, kw_t = dict(state=js), dict(state=ts)
    jy, jst = JS.slstm_block(jp, jnp.asarray(x), jcfg, chunk=chunk, **kw_j)
    ty, tst = S.slstm_block(tp, _t(x), cfg, chunk=chunk, **kw_t)
    _close(ty, jy)
    _close_trees(tst, jst)


def test_slstm_gates_are_head_major():
    """The reference's layout, kept: head i's ``h_i . r[i]`` fills columns
    [4 dh i, 4 dh (i + 1)) of the gate pre-activations, which are split
    into z, i, f, o over the flattened 4D; at 4 heads 4 dh = D, so each
    gate's recurrent term reads one head's state (z head 0, i 1, f 2, o
    3).  Zeroing every block of ``r`` but head 0's leaves the first step
    (h = 0) as it was and moves the later ones, in both packages alike."""
    jcfg, cfg = _configs(XLSTM)
    jp, tp = _both(_shared_tree(XLSTM), 1)
    nh, D = cfg.n_heads, cfg.d_model
    assert 4 * (D // nh) == D
    x = _randn(8, (2, 4, D))
    y0, _ = S.slstm_block(tp, _t(x), cfg)
    cut = dict(tp, r=tp["r"].clone())
    cut["r"][1:] = 0.0
    y1, _ = S.slstm_block(cut, _t(x), cfg)
    assert torch.equal(y0[:, 0], y1[:, 0])
    assert not torch.allclose(y0[:, 1:], y1[:, 1:])
    jy1, _ = JS.slstm_block(dict(jp, r=jnp.asarray(cut["r"].numpy())),
                            jnp.asarray(x), jcfg)
    _close(y1, jy1)


def test_port_chunkwise_matches_recurrent():
    """``tests/test_models.py``'s check on the port alone: outputs and the
    carried state of the chunkwise form equal the recurrent oracle's."""
    _, cfg = _configs(XLSTM)
    rng = np.random.default_rng(3)
    D, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads

    def rn(*shape, std):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * std)
    p = {"ln": torch.zeros(D), "up": rn(D, 2 * di, std=0.05),
         "conv_w": rn(cfg.d_conv, di, std=0.1),
         "wq": rn(di, di, std=0.05), "wk": rn(di, di, std=0.05),
         "wv": rn(di, di, std=0.05), "wif": rn(di, 2 * nh, std=0.5),
         "b_if": rn(2 * nh, std=0.5), "down": rn(di, D, std=0.05)}
    x = rn(2, 48, D, std=1.0)
    y_r, (_, st_r) = S.mlstm_block(p, x, cfg, chunk=16, mode="recurrent")
    y_c, (_, st_c) = S.mlstm_block(p, x, cfg, chunk=16, mode="chunkwise")
    _close(y_c, y_r.numpy())
    for a, b in zip(st_r, st_c):
        _close(b, a.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("block", ["mamba", "slstm", "mlstm_recurrent"])
def test_chunked_scan_refuses_a_partial_chunk(block):
    """S 12 with chunk 8: the reference asserts, the port raises; the
    chunkwise mLSTM alone runs at any chunk (its L search)."""
    arch = JAMBA if block == "mamba" else XLSTM
    jcfg, cfg = _configs(arch)
    jp, tp = _both(_shared_tree(arch), 0 if block != "slstm" else 1)
    x = _randn(9, (2, 12, cfg.d_model))
    jfn, tfn = {"mamba": (JS.mamba_block, S.mamba_block),
                "slstm": (JS.slstm_block, S.slstm_block),
                "mlstm_recurrent": (JS.mlstm_block, S.mlstm_block)}[block]
    kw = {"mode": "recurrent"} if block.startswith("mlstm") else {}
    with pytest.raises(AssertionError, match=r"\(12, 8\)"):
        jfn(jp, jnp.asarray(x), jcfg, chunk=8, **kw)
    with pytest.raises(ValueError, match="12 steps .* chunks of 8"):
        tfn(tp, _t(x), cfg, chunk=8, **kw)
    with pytest.raises(ValueError):
        S.chunked_scan(lambda c, x: (c, x), torch.zeros(1),
                       torch.zeros(12, 3), chunk=8)
    # a whole number of chunks, and one partial chunk no longer than chunk
    for n, chunk in ((12, 4), (5, 8)):
        carry, ys = S.chunked_scan(lambda c, x: (c + x, c + x),
                                   torch.zeros(3), torch.ones(n, 3),
                                   chunk=chunk)
        assert ys.shape == (n, 3) and float(carry[0]) == n


# -- the models ----------------------------------------------------------------

def _tokens(B, S_, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S_)) \
        .astype(np.int32)


def _models(arch, chunk=CHUNK):
    jcfg, cfg = _configs(arch)
    return (JaxModel(jcfg, JaxKnobs(kv_chunk=16, ssm_chunk=chunk)),
            Model(cfg, ModelKnobs(ssm_chunk=chunk), device="cpu"))


def test_forward_logits_match_jax(weights):
    arch, jp, tp = weights
    jm, tm = _models(arch)
    toks = _tokens(2, 16)
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 16, 256)
    _close(got, want)


def test_prefill_and_teacher_forced_decode_match_jax(weights):
    """Prefill (right-padded rows, ``logits_at``) then 4 teacher-forced
    decode steps at ragged positions: logits and every cache leaf."""
    arch, jp, tp = weights
    jm, tm = _models(arch)
    toks = _tokens(2, 20, seed=1)
    S_pre, s_max = 12, 32
    at = np.array([7, 11])
    jlg, jcache, _ = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :S_pre])}, s_max,
        logits_at=jnp.asarray(at))
    tlg, tcache, t_len = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :S_pre])}, s_max, logits_at=torch.from_numpy(at))
    assert t_len == S_pre and len(tcache) == tm.cfg.period
    _close(tlg, jlg)
    _close_trees(tcache, jcache)
    jdecode = jax.jit(jm.decode_step)
    t = at + 1
    for _ in range(4):
        tok = toks[np.arange(2), np.minimum(t, 19)][:, None]
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(t, jnp.int32),
                              {"tokens": jnp.asarray(tok)})
        tlg, tcache = tm.decode_step(tp, tcache, torch.from_numpy(t),
                                     {"tokens": torch.from_numpy(tok)})
        _close(tlg, jlg)
        t = t + 1
    _close_trees(tcache, jcache)


def test_cache_layout_matches_jax_init_cache(weights):
    """One entry per position, each leaf (n_periods, B, ...); SSM states
    f32, m at -1e30; the same nesting as the reference's."""
    arch, _, _ = weights
    jm, tm = _models(arch)
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jc)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tc))
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape and a.shape[:2] == (2, 3)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_prefill_decode_matches_forward(arch):
    """Port alone (``tests/test_models.py``'s check): teacher-forced decode
    after prefill reproduces the full-sequence forward logits.  jamba's
    MoE takes the dense dispatch: the sort dispatch's capacity depends on
    the number of tokens, so a 2-token decode step may drop pairs that the
    32-token forward keeps."""
    _, cfg = _configs(arch)
    model = Model(cfg, ModelKnobs(ssm_chunk=CHUNK, moe_dispatch="dense"),
                  device="cpu")
    params = params_from_jax(_shared_tree(arch), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 16, seed=2))
    full = model.forward(params, {"tokens": toks})
    lg, cache, _ = model.prefill(params, {"tokens": toks[:, :8]}, 16)
    _close(lg, full[:, 7], rtol=2e-2, atol=2e-3)
    for t in range(8, 16):
        lg, cache = model.decode_step(params, cache, t,
                                      {"tokens": toks[:, t:t + 1]})
        _close(lg, full[:, t], rtol=2e-2, atol=2e-3)


# per arch: (JAX model, jitted decode, jitted prefills by padded length),
# shared by the engine cases, which differ only in their buckets
_JAX_ENGINE_JITS = {}
# prompt lengths: under the buckets (8, 16) the 5-token prompt is padded to
# 8, and every padded length is one that the unbucketed run compiles too
ENGINE_PROMPTS = (5, 8, 16)


@pytest.mark.parametrize("buckets", [(), (8, 16)])
def test_engine_greedy_tokens_equal_jax(weights, buckets):
    """3 requests over 2 slots (prefill, the splice of every cache leaf,
    retire and refill), with and without prompt buckets: the JAX engine's
    tokens.  The two cases' JAX engines share their jitted prefill and
    decode (they close over the model and ``s_max``, which the cases
    share), so each prompt length compiles once an architecture."""
    arch, jp, tp = weights
    jcfg, cfg = _configs(arch)
    kw = dict(batch_size=2, s_max=48, max_new_tokens=5,
              prompt_buckets=buckets)
    if arch not in _JAX_ENGINE_JITS:
        _JAX_ENGINE_JITS[arch] = (JaxModel(jcfg, JaxKnobs(kv_chunk=16)),
                                  None, {})
    jmodel, decode, prefills = _JAX_ENGINE_JITS[arch]
    jeng = JaxEngine(jmodel, jp, JaxServeConfig(**kw))
    jeng._decode = decode or jeng._decode
    jeng._prefill_cache = prefills
    _JAX_ENGINE_JITS[arch] = (jmodel, jeng._decode, prefills)
    eng = Engine(Model(cfg, device="cpu"), tp, ServeConfig(**kw))
    for uid, n in enumerate(ENGINE_PROMPTS):
        prompt = (np.arange(n, dtype=np.int32) * 5 + uid) % 256
        jeng.submit(JaxRequest(uid, prompt))
        eng.submit(Request(uid, prompt))
    want = {u: r.tokens for u, r in jeng.run().items()}
    got = {u: r.tokens for u, r in eng.run().items()}
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert got == want


def test_bucketed_prefill_runs_the_state_over_pads(weights):
    """A quirk of the reference, kept: a prompt padded to its bucket gives
    the same last-token logits (causal), and attention's K/V over the true
    tokens are the same, but an SSM's carried state has run over the pad
    tokens, in both packages alike.  The MoE takes the dense dispatch: the
    sort dispatch's capacity depends on the padded length."""
    arch, jp, tp = weights
    jcfg, cfg = _configs(arch)
    jm = JaxModel(jcfg, JaxKnobs(kv_chunk=16, moe_dispatch="dense"))
    tm = Model(cfg, ModelKnobs(moe_dispatch="dense"), device="cpu")
    prompt = _tokens(1, 5, seed=4)
    padded = np.zeros((1, 8), np.int32)
    padded[:, :5] = prompt
    at = np.array([4])
    runs = {}
    for name, toks in (("exact", prompt), ("bucket", padded)):
        runs[name] = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16,
                                logits_at=torch.from_numpy(at))
    _close(runs["bucket"][0], runs["exact"][0].numpy())
    jlg, jcache, _ = jm.prefill(jp, {"tokens": jnp.asarray(padded)}, 16,
                                logits_at=jnp.asarray(at))
    _close_trees(runs["bucket"][1], jcache)
    for kind, ce, cb in zip(tm.cfg.pattern, runs["exact"][1],
                            runs["bucket"][1]):
        if kind == "attn":
            for a, b in zip(ce, cb):
                _close(b[:, :, :5], a[:, :, :5].numpy())
        else:
            assert not all(torch.allclose(a, b) for a, b in zip(
                jax.tree.leaves(ce), jax.tree.leaves(cb)))


# -- parameters ----------------------------------------------------------------

def test_params_from_jax_over_every_position():
    jcfg, cfg = _configs(JAMBA)
    tree = _shared_tree(JAMBA)
    port = params_from_jax(tree, cfg, device="cpu")
    assert sorted(port) == sorted(["embed", "final", "head"]
                                  + [f"pos{i}" for i in range(8)])
    P, D, di = cfg.n_periods, cfg.d_model, cfg.d_inner
    assert port["pos4"]["mix_wq"].shape == (P, D, 4 * 8)
    assert port["pos4"]["mix_wo"].shape == (P, 4 * 8, D)
    np.testing.assert_array_equal(port["pos4"]["mix_wk"].numpy(),
                                  tree["pos4"]["mix_wk"].reshape(P, D, -1))
    for i in (0, 1, 7):
        for nm, a in tree[f"pos{i}"].items():   # SSM, dense, MoE: as in JAX
            np.testing.assert_array_equal(port[f"pos{i}"][nm].numpy(), a)
    assert port["pos0"]["mix_x_proj"].shape == (P, di, di // 16 + 8)
    assert "ffn_router" in port["pos1"] and "ffn_w_gate" in port["pos0"]
    bad = _shared_tree(JAMBA)
    del bad["pos7"]
    with pytest.raises(ValueError, match="groups"):
        params_from_jax(bad, cfg, device="cpu")
    bad = _shared_tree(JAMBA)
    bad["pos3"]["mix_a_log"] = bad["pos3"]["mix_a_log"][..., :3]
    with pytest.raises(ValueError, match="pos3/mix_a_log"):
        params_from_jax(bad, cfg, device="cpu")
    xt = _shared_tree(XLSTM)
    del xt["pos1"]["mix_r"]
    with pytest.raises(ValueError, match="pos1"):
        params_from_jax(xt, _configs(XLSTM)[1], device="cpu")


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_ssm_init_values(arch):
    """The JAX init's constants exactly (a_log = log(1..N), dt_b =
    log(expm1(0.01)), d ones, biases and norms zero) and its drawn
    weights' scales (conv_w fan-in d_conv, r fan-in dh)."""
    jcfg, cfg = _configs(arch)
    jt = _jax_init(arch)
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {g: {k: tuple(v.shape) for k, v in s.items()}
            for g, s in tp.items()} == \
        {g: {k: tuple(v.shape) for k, v in s.items()}
         for g, s in params_from_jax(jt, cfg, device="cpu").items()}
    for g, sub in tp.items():
        for nm, w in sub.items():
            if nm.endswith(("a_log", "dt_b", "mix_d", "ln", "b_if",
                            "mix_b")):
                np.testing.assert_allclose(w.numpy(), jt[g][nm], rtol=1e-6)
    consts = [v for g in tp if g.startswith("pos")
              for k, v in tp[g].items() if k.endswith("a_log")]
    for a in consts:
        np.testing.assert_allclose(
            a[0, 0].numpy(), np.log(np.arange(1, cfg.d_state + 1)),
            rtol=1e-6)
    # the drawn weights' fan-ins, as the reference's _kind_params
    spec = spec_tree(get_config(arch))
    P = get_config(arch).n_periods
    full = get_config(arch)
    if arch == XLSTM:
        assert spec["pos1"]["mix_r"] == ((P, 4, 192, 768), 192)
        r = tp["pos1"]["mix_r"]
        assert abs(float(r.std()) * math.sqrt(r.shape[2]) - 1) < 0.05
    assert spec["pos0"]["mix_conv_w"] == ((P, 4, full.d_inner), 4)
    assert abs(float(tp["pos0"]["mix_conv_w"].std()) * 2 - 1) < 0.1


# -- entry points --------------------------------------------------------------

@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_serve_cli_reduced(arch):
    eng = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--batch", "2"])
    assert len(eng.results) == 3
    assert all(len(r.tokens) == 4 for r in eng.results.values())

