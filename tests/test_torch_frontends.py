"""The two frontend stubs in the port against the JAX package, on shared
weights (CPU, f32): musicgen-large's codebooks and internvl2-2b's patch
prefix, reduced (2 layers, d_model 64, 4/2 heads of 8, d_ff 128, vocab
256; musicgen 4 codebooks, internvl2 8 patches).

- ``params_from_jax`` carries the codebook tables ``(ncb, V, D)`` and head
  ``(ncb, D, V)`` with their shapes checked (a wrong codebook count
  refused);
- forward logits, ``(B, S, ncb, V)`` with codebooks, over the patch
  prefix's positions too;
- prefill and teacher-forced decode: musicgen's ``(B, 1, ncb)`` steps,
  internvl2's decode after a patch prefill at positions P + i (as
  ``tests/test_models.py``'s ``test_vlm_prefill_decode_matches_forward``),
  against the JAX package's prefill and decode and its full forward;
- the engines' greedy tokens equal (codebook tokens as lists of 4, no EOS
  stop) and the serve CLI's codebook prompts;
- the study: its 12 points' signatures and counts, and the
  ``embed_loss_fb`` (codebooks; patches), ``attn_fb`` and ``dense_fb``
  gradients against ``jax.grad`` of the JAX study's closures.

Tolerances as ``tests/test_torch_models.py``: logits within rtol 1e-4 /
atol 1e-5, gradients within atol 1e-5 x the tensor's largest magnitude.
The tree is drawn with numpy from the JAX package's own spec
(``_spec_tree``), the norms drawn too.
"""

import math
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import _spec_tree
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.tune import lm_study as jax_lm_study
from repro.tune.lm_study import LMStudy as JaxStudy
from repro.tune.lm_study import StepKnobs as JaxStepKnobs
from repro.tune.lm_study import lm_config_space as jax_space
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.tune import LMStudy, StepKnobs, lm_config_space

RTOL, ATOL = 1e-4, 1e-5
MUSICGEN, INTERNVL = "musicgen-large", "internvl2-2b"


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def numpy_tree(arch, seed=0):
    """A JAX-layout tree of the reduced ``arch``, drawn with numpy:
    weights N(0, 1/fan_in), embeddings N(0, 0.02^2), norms N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for g, sub in sorted(_spec_tree(jax_get_config(arch,
                                                   reduced=True)).items()):
        for nm, (shape, _, fan) in sorted(sub.items()):
            std = (0.1 if fan == 0.0 else 0.02 if fan == -1
                   else 1.0 / math.sqrt(fan))
            tree.setdefault(g, {})[nm] = \
                (rng.standard_normal(shape) * std).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=[MUSICGEN, INTERNVL])
def weights(request):
    """(arch, JAX params, port params) on the same weights."""
    arch = request.param
    tree = numpy_tree(arch)
    return (arch, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, get_config(arch, reduced=True),
                            device="cpu"))


def _batch(cfg, B, S, seed):
    """Tokens ``(B, S[, ncb])`` and, with patches, ``(B, P, D)`` patches
    drawn N(0, 0.1^2) (``tests/test_models.py``'s ``make_batch``)."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab, size=shape).astype(np.int32)}
    if cfg.n_patches:
        out["patches"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_params_from_jax_checks_codebook_shapes():
    cfg = get_config(MUSICGEN, reduced=True)
    tree = numpy_tree(MUSICGEN)
    port = params_from_jax(tree, cfg, device="cpu")
    assert port["embed"]["tok"].shape == (4, 256, 64)
    assert port["head"]["w"].shape == (4, 64, 256)
    np.testing.assert_array_equal(port["head"]["w"].numpy(),
                                  tree["head"]["w"])
    for g, cut in (("embed", np.s_[:3]), ("head", np.s_[:3])):
        bad = numpy_tree(MUSICGEN)
        nm = "tok" if g == "embed" else "w"
        bad[g][nm] = bad[g][nm][cut]
        with pytest.raises(ValueError, match=f"{g}/{nm}"):
            params_from_jax(bad, cfg, device="cpu")
    # a text model's table is not a codebook table
    bad = numpy_tree(MUSICGEN)
    bad["embed"]["tok"] = bad["embed"]["tok"][0]
    with pytest.raises(ValueError, match="embed/tok"):
        params_from_jax(bad, cfg, device="cpu")
    vlm = params_from_jax(numpy_tree(INTERNVL),
                          get_config(INTERNVL, reduced=True), device="cpu")
    assert vlm["embed"]["tok"].shape == (256, 64)
    assert vlm["head"]["w"].shape == (64, 256)


def test_forward_logits_match_jax(weights):
    arch, jp, tp = weights
    cfg = get_config(arch, reduced=True)
    jb, tb = _both(_batch(cfg, 2, 12, seed=1))
    want = jax.jit(JaxModel(jax_get_config(arch, reduced=True)).forward)(
        jp, jb)
    got = Model(cfg, device="cpu").forward(tp, tb)
    P = cfg.n_patches
    assert got.shape == ((2, 12, 4, 256) if cfg.n_codebooks
                         else (2, P + 12, 256))
    _close(got, want)


def test_prefill_and_teacher_forced_decode_match_jax(weights):
    """Prefill of 6 tokens (after the patch prefix: t = P + 6), then 6
    teacher-forced decode steps at absolute positions P + i: each against
    the JAX package's prefill and decode and the full forward."""
    arch, jp, tp = weights
    cfg = get_config(arch, reduced=True)
    jm = JaxModel(jax_get_config(arch, reduced=True))
    model = Model(cfg, device="cpu")
    B, S_text, S_pre, P = 2, 12, 6, cfg.n_patches
    batch = _batch(cfg, B, S_text, seed=2)
    toks = batch["tokens"]
    jb, tb = _both(batch)
    full = model.forward(tp, tb)
    s_max = P + S_text + 4
    pre = dict(batch, tokens=toks[:, :S_pre])
    jpre, tpre = _both(pre)
    jlg, jcache, jt = jax.jit(lambda p, b: jm.prefill(p, b, s_max))(jp, jpre)
    lg, cache, t0 = model.prefill(tp, tpre, s_max)
    assert t0 == jt == P + S_pre
    assert lg.shape == ((B, 4, 256) if cfg.n_codebooks else (B, 256))
    _close(lg, jlg)
    _close(lg, full[:, P + S_pre - 1].numpy())
    step = jax.jit(jm.decode_step)
    for i in range(S_pre, S_text):
        tok = toks[:, i:i + 1]
        jlg, jcache = step(jp, jcache, jnp.int32(P + i),
                           {"tokens": jnp.asarray(tok)})
        lg, cache = model.decode_step(tp, cache, P + i,
                                      {"tokens": torch.from_numpy(tok)})
        _close(lg, jlg)
        _close(lg, full[:, P + i].numpy())


def _prompts(cfg):
    rng = np.random.default_rng(5)
    trail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return [rng.integers(0, cfg.vocab, size=(n,) + trail).astype(np.int32)
            for n in (4, 7, 10)]


def test_engine_greedy_tokens_equal_jax(weights):
    """3 requests over 2 slots: prefill, the cache splice, retire and
    refill and the ragged decode give the JAX engine's tokens (codebook
    tokens as lists of 4); an EOS id stops no codebook request, as in
    JAX."""
    arch, jp, tp = weights
    cfg = get_config(arch, reduced=True)
    kw = dict(batch_size=2, s_max=32, max_new_tokens=4,
              eos_id=0 if cfg.n_codebooks else None)
    jeng = JaxEngine(JaxModel(jax_get_config(arch, reduced=True)), jp,
                     JaxServeConfig(**kw))
    eng = Engine(Model(cfg, device="cpu"), tp, ServeConfig(**kw))
    for uid, prompt in enumerate(_prompts(cfg)):
        jeng.submit(JaxRequest(uid, prompt))
        eng.submit(Request(uid, prompt))
    want = {u: r.tokens for u, r in jeng.run().items()}
    got = {u: r.tokens for u, r in eng.run().items()}
    assert len(got) == 3 and all(len(t) == 4 for t in got.values())
    if cfg.n_codebooks:
        assert all(isinstance(t, list) and len(t) == 4
                   and all(isinstance(c, int) for c in t)
                   for r in got.values() for t in r)
    assert got == want


def test_serve_main_codebook_prompts(capsys):
    eng = serve.main(["--arch", MUSICGEN, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "3", "--batch", "2"])
    assert sorted(eng.results) == [0, 1, 2]
    assert all(len(r.tokens) == 3 and all(len(t) == 4 for t in r.tokens)
               for r in eng.results.values())
    reqs = serve.synthetic_requests(3, 256, 0, n_codebooks=4)
    rng = np.random.default_rng(0)   # the JAX launch/serve.py's draw
    for r in reqs:
        n = int(rng.integers(4, 32))
        np.testing.assert_array_equal(
            r.tokens, rng.integers(0, 256, size=(n, 4)).astype(np.int32))
    assert "3 requests, 9 tokens" in capsys.readouterr().out


# -- the study ----------------------------------------------------------------

@pytest.fixture(scope="module")
def studies():
    """{arch: (JAX study, port study)} on one numpy tree each and on the
    JAX study's batch (codebook tokens, N(0, 1) patches)."""
    out = {}
    for arch in (MUSICGEN, INTERNVL):
        tree = numpy_tree(arch, seed=1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_lm_study, "init_params",
                       lambda cfg, key: jax.tree.map(jnp.asarray, tree))
            js = JaxStudy(arch, batch=2, seq=32)
        ts = LMStudy(arch, batch=2, seq=32, device="cpu")
        ts.params = params_from_jax(tree, ts.cfg, device="cpu")
        ts.batch_data = {k: torch.from_numpy(np.array(v))
                         for k, v in js.batch_data.items()}
        out[arch] = js, ts
    return out


def test_study_batch_shapes(studies):
    for arch, (js, ts) in studies.items():
        cfg = ts.cfg
        fresh = LMStudy(arch, batch=2, seq=32, device="cpu").batch_data
        for k, v in js.batch_data.items():
            assert tuple(fresh[k].shape) == v.shape, k
        assert set(fresh) == ({"tokens", "labels", "patches"}
                              if cfg.n_patches else {"tokens", "labels"})
        if cfg.n_codebooks:
            assert fresh["tokens"].shape == (2, 32, 4)
        else:
            assert fresh["patches"].shape == (2, 8, 64)
            assert abs(float(fresh["patches"].std()) - 1.0) < 0.2


@pytest.mark.parametrize("arch,index", [(a, i) for a in (MUSICGEN, INTERNVL)
                                        for i in range(12)])
def test_kernel_sequence_matches_jax(studies, arch, index):
    js, ts = studies[arch]
    jkn, tkn = jax_space(js.cfg)[index], lm_config_space(ts.cfg)[index]
    assert asdict(tkn) == asdict(jkn)
    sigs = [[(s.kind, s.name, s.params, f) for s, _, f in st.kernel_sequence(
        kn)] for st, kn in ((ts, tkn), (js, jkn))]
    assert sigs[0] == sigs[1]
    assert {s[1] for s in sigs[0]} == {"attn_fb", "dense_fb",
                                       "embed_loss_fb", "adamw"}


def _close_grads(tg, jg):
    assert set(tg) == set(jg)
    for k in tg:
        if isinstance(jg[k], dict):
            _close_grads(tg[k], jg[k])
            continue
        want = np.asarray(jg[k])
        peak = float(np.abs(want).max())
        assert peak > 0.0, k
        _close(tg[k].reshape(want.shape), want, atol=ATOL * max(1.0, peak))


@pytest.mark.parametrize("arch", [MUSICGEN, INTERNVL])
@pytest.mark.parametrize("thunk", ["embed", "attn", "dense"])
def test_study_thunk_grads_match_jax(studies, arch, thunk):
    """embed_loss_fb over the codebook tables and head (musicgen) or over
    the patch prefix's positions too (internvl2), attn_fb and dense_fb of
    layer 0, against ``jax.grad`` of the JAX study's closures."""
    js, ts = studies[arch]
    kn = dict(kv_chunk=16, remat="full" if thunk == "attn" else "none")
    jk, tk = JaxStepKnobs("k", **kn), StepKnobs("k", **kn)
    if thunk == "embed":
        (jsig, jb), (tsig, tb) = (js._embed_loss_kernel(jk, 2),
                                  ts._embed_loss_kernel(tk, 2))
        jfn, jargs = jb()
        tfn, targs = tb()
        assert (tsig.name, tsig.params) == (jsig.name, jsig.params)
        _close_grads(tfn(*targs), jfn(*jargs))
        return
    make = "_mixer_kernel" if thunk == "attn" else "_ffn_kernel"
    jsig, jb = getattr(js, make)(thunk, 0, jk, 2)
    tsig, tb = getattr(ts, make)(thunk, 0, tk, 2)
    assert (tsig.name, tsig.params) == (jsig.name, jsig.params)
    jfn, (jw, _) = jb()
    tfn, (tw, _) = tb()
    x = np.random.default_rng(7).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    _close_grads(tfn(tw, torch.from_numpy(x)), jfn(jw, jnp.asarray(x)))
