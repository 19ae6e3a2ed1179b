"""The port's MoE FFN and MoE family against the JAX package, on shared
weights (phi3.5-moe reduced: d_model 64, 4/2 heads of 8, 4 experts of
d_ff 64 with top-2 routing, vocab 256, 2 layers; CPU, f32).

The JAX ``init_params`` tree is carried across by ``params_from_jax`` with
its norm weights randomized, ``ffn_ln`` included (the MoE FFN reads no
norm, in both packages, so a port that did would differ).  Inputs are made
with numpy from a seed and given to both sides.

- ``moe_ffn`` under the sort, dense and a2a dispatches at the default
  capacity factor (1.25: pairs are dropped), at a tight 0.5, and with one
  shared expert: the routed experts equal JAX's ``router_topk``, the kept
  pairs equal the reference's capacity rule (stable argsort by expert,
  first ``cap`` per expert), and the outputs agree;
- the model's forward, prefill and teacher-forced decode logits against
  the JAX ``Model``;
- the study's ``moe_fb`` gradients against ``jax.grad`` of the JAX study's
  closure; its configuration space, signatures and counts against the JAX
  study's; the sort and dense points share every attention kernel and no
  MoE kernel;
- ties: all-zero router logits pick ``lax.top_k``'s experts (the lower
  index first) and gates, and a zero router routes ``moe_ffn`` as JAX
  does under sort and dense;
- ``check_supported`` still rejects the families the port does not run,
  and deepseek-v2 (MLA with this MoE FFN) constructs as a model and as a
  study.

The JAX side runs under ``jax.jit`` (one program a shape, where eager mode
compiles every primitive on its first call), and the JAX weights are drawn
once a configuration.

Tolerances as ``tests/test_torch_models.py`` (rtol 1e-4, atol 1e-5: the
same f32 arithmetic in another order) and ``tests/test_torch_grads.py``
(gradients: atol 1e-5 times each tensor's largest magnitude).
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JM
from repro.models.model import Model as JaxModel, ModelKnobs as JaxKnobs
from repro.tune import lm_study as jax_lm_study
from repro.tune.lm_study import LMStudy as JaxStudy
from repro.tune.lm_study import StepKnobs as JaxStepKnobs
from repro.tune.lm_study import lm_config_space as jax_space
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, ModelKnobs
from repro_torch.tune import LMStudy, StepKnobs, lm_config_space
from repro_torch.tune.lm_study import MOE_UNREAD, grad_closure, moe_loss

RTOL, ATOL = 1e-4, 1e-5
ARCH = "phi3.5-moe"


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _configs(n_shared=0, capacity_factor=1.25):
    """(JAX config, port config) of reduced phi3.5-moe."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(ARCH, reduced=True)
        out.append(replace(cfg, moe=replace(
            cfg.moe, n_shared=n_shared, capacity_factor=capacity_factor)))
    return tuple(out)


_TREES = {}
_JAX_FFN = {}


def _shared_tree(jcfg, seed=0):
    """A copy of the JAX init tree as numpy, norm weights randomized."""
    if (jcfg, seed) not in _TREES:
        tree = jax.tree.map(np.asarray, jax.jit(JaxModel(jcfg).init)(
            jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed)
        for sub in tree.values():
            for nm in sub:
                if nm.endswith("ln"):
                    sub[nm] = (rng.standard_normal(sub[nm].shape) * 0.1
                               ).astype(np.float32)
        _TREES[jcfg, seed] = tree
    return jax.tree.map(np.copy, _TREES[jcfg, seed])


@pytest.fixture(scope="module")
def weights():
    """n_shared -> (JAX params, port params) on the same weights."""
    out = {}
    for n_shared in (0, 1):
        jcfg, cfg = _configs(n_shared)
        tree = _shared_tree(jcfg)
        out[n_shared] = (jax.tree.map(jnp.asarray, tree),
                         params_from_jax(tree, cfg, device="cpu"))
    return out


def _jax_moe_ffn(p, x, cfg, dispatch, key):
    """JAX ``moe_ffn`` under ``jax.jit``, once a ``key``.  With no mesh JAX
    runs ``a2a`` as ``sort`` (``src/repro/models/moe.py:74-78``), so one
    reference serves both."""
    dispatch = "sort" if dispatch == "a2a" else dispatch
    if (key, dispatch) not in _JAX_FFN:
        _JAX_FFN[key, dispatch] = np.asarray(jax.jit(
            JM.moe_ffn, static_argnames=("cfg", "dispatch"))(
                p, x, cfg=cfg, dispatch=dispatch))
    return _JAX_FFN[key, dispatch]


def _ffn0(params):
    return {k[len("ffn_"):]: v[0] for k, v in params["pos0"].items()
            if k.startswith("ffn_")}


def _reference_kept(idx, n_experts, cap):
    """The reference's kept pairs (T, k), token order: a stable argsort by
    expert (as ``jnp.argsort``), each expert's first ``cap`` pairs."""
    fidx = np.asarray(idx).reshape(-1)
    order = np.argsort(fidx, kind="stable")
    counts = np.bincount(fidx, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    pos = np.arange(fidx.shape[0]) - starts[fidx[order]]
    kept = np.empty(fidx.shape[0], bool)
    kept[order] = pos < cap
    return kept.reshape(idx.shape)


def test_router_topk_matches_jax():
    logits = np.random.default_rng(0).standard_normal((13, 16)) \
        .astype(np.float32)
    jg, ji = JM.router_topk(jnp.asarray(logits), 2)
    tg, ti = moe.router_topk(torch.from_numpy(logits), 2)
    assert tg.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)


@pytest.mark.parametrize("n_experts,k", [(4, 2), (16, 2), (160, 6)])
def test_router_topk_ties_match_jax(n_experts, k):
    """All-zero logits tie every expert: ``lax.top_k`` keeps the lower
    index first, and so must the port (phi3.5-moe's 16/top-2, deepseek-v2's
    160/top-6, the reduced 4/top-2); some rows tie only partly."""
    logits = np.zeros((5, n_experts), np.float32)
    logits[3, n_experts // 2:] = 1.0        # the upper half tied on top
    logits[4, ::3] = -1.0
    jg, ji = JM.router_topk(jnp.asarray(logits), k)
    tg, ti = moe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[0].numpy(), np.arange(k))
    _close(tg, jg)


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_ffn_zero_router_matches_jax(weights, dispatch):
    """A zero router ties every probability for every token: the port
    routes to JAX's experts (0 and 1) and the outputs agree."""
    jcfg, cfg = _configs()
    jp, tp = weights[0]
    jl, tl = _ffn0(jp), _ffn0(tp)
    jl["router"] = jnp.zeros_like(jl["router"])
    tl["router"] = torch.zeros_like(tl["router"])
    x = np.random.default_rng(8).standard_normal((1, 4, 64)) \
        .astype(np.float32)
    routing = []
    got = moe.moe_ffn(tl, torch.from_numpy(x), cfg, dispatch=dispatch,
                      routing=routing)
    want = jax.jit(JM.moe_ffn, static_argnames=("cfg", "dispatch"))(
        jl, jnp.asarray(x), cfg=jcfg, dispatch=dispatch)
    np.testing.assert_array_equal(routing[0][0].numpy(),
                                  np.tile([0, 1], (4, 1)))
    _close(got, want)


@pytest.mark.parametrize("tk,n_experts,cf,cap", [
    (8, 16, 1.25, 1),        # a 4-slot decode step of phi3.5-moe
    (2, 16, 1.25, 1),        # one token: round gives 0, raised to 1
    (62, 16, 1.25, 5),       # a 31-token prompt
    (20, 16, 1.25, 2),       # 10 tokens: round(1.5625)
    (20, 4, 0.5, 2),         # round(2.5) is 2 (Python rounds half to even)
    (240, 4, 1.25, 75),      # the last unpadded size
    (256, 4, 1.25, 256),     # from 256 pairs on, a multiple of 256
    (1024, 4, 1.25, 512)])
def test_sort_capacity(tk, n_experts, cf, cap):
    assert moe.sort_capacity(tk, n_experts, cf) == cap


CASES = {"default": dict(), "tight": dict(capacity_factor=0.5),
         "shared": dict(n_shared=1)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dispatch", ["sort", "dense", "a2a"])
def test_moe_ffn_matches_jax(weights, dispatch, case):
    """Routing, kept pairs and outputs at a 13-token prompt and a 4-row
    decode step (both drop pairs at the default factor)."""
    kw = CASES[case]
    jcfg, cfg = _configs(**kw)
    jp, tp = weights[kw.get("n_shared", 0)]
    jl, tl = _ffn0(jp), _ffn0(tp)
    dropped = 0
    for seed, shape in ((0, (1, 13)), (1, (4, 1))):
        x = np.random.default_rng(seed).standard_normal(shape + (64,)) \
            .astype(np.float32)
        routing = []
        got = moe.moe_ffn(tl, torch.from_numpy(x), cfg, dispatch=dispatch,
                          routing=routing)
        want = _jax_moe_ffn(jl, jnp.asarray(x), jcfg, dispatch, (case, seed))
        _close(got, want)
        (idx, kept), = routing
        xf = jnp.asarray(x.reshape(-1, 64))
        _, jidx = JM.router_topk(xf @ jl["router"], cfg.moe.top_k)
        jidx = np.asarray(jidx)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        if dispatch == "dense":
            assert bool(kept.all())
            continue
        tk = jidx.size
        cap = int(max(1, round(tk / cfg.moe.n_experts
                               * cfg.moe.capacity_factor)))
        np.testing.assert_array_equal(
            kept.numpy(), _reference_kept(jidx, cfg.moe.n_experts, cap))
        dropped += int((~kept).sum())
    if dispatch != "dense":
        assert dropped > (10 if case == "tight" else 0)


def test_unknown_dispatch_raises(weights):
    _, cfg = _configs()
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(_ffn0(weights[0][1]), torch.zeros(1, 2, 64), cfg,
                    dispatch="ring")


def _tokens(B, S, seed=6):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("dispatch", ["a2a", "sort", "dense"])
def test_forward_logits_match_jax(weights, dispatch, monkeypatch):
    """The logits, with every layer routed through ``moe.moe_ffn`` (its
    calls recorded by wrapping it)."""
    jcfg, cfg = _configs()
    jp, tp = weights[0]
    toks = _tokens(2, 16)
    jm = JaxModel(jcfg, JaxKnobs(kv_chunk=16, moe_dispatch=dispatch))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    routes, ffn = [], moe.moe_ffn
    monkeypatch.setattr(moe, "moe_ffn",
                        lambda *a, **kw: ffn(*a, routing=routes, **kw))
    model = Model(cfg, ModelKnobs(moe_dispatch=dispatch), device="cpu")
    got = model.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 16, 256)
    _close(got, want)
    assert len(routes) == cfg.n_layers


def test_prefill_and_teacher_forced_decode_match_jax(weights):
    """Prefill (a right-padded row, ``logits_at``) then 6 teacher-forced
    decode steps of 2 rows at ragged positions; the rows share each
    step's expert capacity, as in JAX."""
    jcfg, cfg = _configs()
    jp, tp = weights[0]
    jm = JaxModel(jcfg, JaxKnobs(kv_chunk=16))
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


def test_serve_main_cpu(capsys):
    eng = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--batch", "2"])
    assert sorted(eng.results) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in eng.results.values())
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_params_from_jax_checks_moe_shapes():
    jcfg, cfg = _configs()
    tree = _shared_tree(jcfg)
    tree["pos0"]["ffn_w_gate"] = tree["pos0"]["ffn_w_gate"][:, :3]
    with pytest.raises(ValueError, match="ffn_w_gate"):
        params_from_jax(tree, cfg, device="cpu")
    tree = _shared_tree(_configs(n_shared=1)[0])
    with pytest.raises(ValueError, match="ffn_sh_"):
        params_from_jax(tree, cfg, device="cpu")


# -- the study ------------------------------------------------------------

@pytest.fixture(scope="module")
def studies(weights):
    """(JAX study, port study) on the same weights (the JAX study is built
    on them, not on a draw of its own that it would then drop)."""
    tree = jax.tree.map(np.asarray, weights[0][0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lm_study, "init_params",
                   lambda cfg, key: jax.tree.map(jnp.asarray, tree))
        js = JaxStudy(ARCH, batch=2, seq=32)
    ts = LMStudy(ARCH, batch=2, seq=32, device="cpu")
    ts.params = params_from_jax(tree, ts.cfg, device="cpu")
    return js, ts


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_fb_grads_match_jax(studies, dispatch, remat):
    js, ts = studies
    kn = dict(moe_dispatch=dispatch, remat=remat)
    _, jbuild = js._ffn_kernel("moe", 0, JaxStepKnobs("k", **kn), 2)
    _, tbuild = ts._ffn_kernel("moe", 0, StepKnobs("k", **kn), 2)
    jfn, (jffn, _) = jbuild()
    tfn, (tffn, _) = tbuild()
    x = np.random.default_rng(3).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    jg = jfn(jffn, jnp.asarray(x))
    tg = tfn(tffn, torch.from_numpy(x))
    assert set(tg) == set(jg) == {"ln", "router", "w_gate", "w_up",
                                  "w_down"}
    for k in tg:
        want = np.asarray(jg[k])
        scale = max(1.0, float(np.abs(want).max()))
        _close(tg[k], want, atol=ATOL * scale)
    assert float(tg["ln"].abs().max()) == 0.0     # the unread norm


def test_config_space_matches_jax(studies):
    js, ts = studies
    assert [asdict(k) for k in lm_config_space(ts.cfg)] == \
        [asdict(k) for k in jax_space(js.cfg)]
    assert len(lm_config_space(ts.cfg)) == 24


@pytest.mark.parametrize("index", range(24))
def test_kernel_sequence_matches_jax(studies, index):
    js, ts = studies
    jseq = js.kernel_sequence(jax_space(js.cfg)[index])
    tseq = ts.kernel_sequence(lm_config_space(ts.cfg)[index])
    assert [(s.kind, s.name, s.params, f) for s, _, f in tseq] == \
        [(s.kind, s.name, s.params, f) for s, _, f in jseq]


def test_dispatch_changes_only_the_moe_kernels(studies):
    """The sort and dense points share every attention kernel and no MoE
    kernel: the paper's kernel sharing at its plainest."""
    _, ts = studies
    sigs = {"sort": set(), "dense": set()}
    for kn in lm_config_space(ts.cfg):
        sigs[kn.moe_dispatch] |= {s for s, _, _ in ts.kernel_sequence(kn)}
    for name in ("attn_fb", "moe_fb"):
        sort = {s for s in sigs["sort"] if s.name == name}
        dense = {s for s in sigs["dense"] if s.name == name}
        assert sort and dense
        assert (sort == dense) if name == "attn_fb" else not sort & dense


@pytest.mark.parametrize("remat", ["none", "full"])
def test_grad_closure_names_the_unread_norm(weights, remat):
    """Only a parameter named unread gets zeros: the MoE loss without
    ``MOE_UNREAD`` raises on its norm, and naming a parameter the loss
    reads raises too."""
    _, cfg = _configs()
    ffn = _ffn0(weights[0][1])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 6, 64)).astype(np.float32))
    cpu = torch.device("cpu")
    loss = moe_loss(cfg, "sort")
    g = grad_closure(loss, remat, cpu, unread=MOE_UNREAD)(ffn, x)
    assert float(g["ln"].abs().max()) == 0.0
    assert float(g["router"].abs().max()) > 0.0
    for unread in ((), MOE_UNREAD + ("router",)):
        with pytest.raises(RuntimeError, match="ln" if not unread
                           else "router"):
            grad_closure(loss, remat, cpu, unread=unread)(ffn, x)


@pytest.mark.parametrize("arch", ["jamba", "xlstm-125m", "musicgen-large",
                                  "internvl2-2b"])
def test_other_families_still_rejected(arch):
    """The other families construct as a model and as a study (the SSM
    ones and the frontend stubs since their slice), and a study's step
    has a ``moe_fb`` only where the configuration has MoE layers."""
    cfg = get_config(arch, reduced=True)
    Model(cfg, device="cpu")
    study = LMStudy(arch, device="cpu")
    names = {s.name for s, _, _ in study.kernel_sequence(
        lm_config_space(study.cfg)[0])}
    assert ("moe_fb" in names) == (cfg.moe is not None)


def test_deepseek_v2_study_still_rejected():
    """deepseek-v2 (MLA, and this MoE FFN with shared experts) constructs
    as a model and as a study, whose steps run its ``moe_fb`` beside
    ``mla_fb`` (``tests/test_torch_mla.py`` holds their signatures)."""
    Model(get_config("deepseek-v2", reduced=True), device="cpu")
    study = LMStudy("deepseek-v2", device="cpu")
    names = {s.name: s.params for s, _, _ in study.kernel_sequence(
        lm_config_space(study.cfg)[1])}
    assert names["moe_fb"] == (2, 32, 64, "dense", "none")
    assert names["mla_fb"] == (2, 32, 64, 16, "none")
