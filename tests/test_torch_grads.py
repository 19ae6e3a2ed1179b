"""Gradients through the port against ``jax.grad``, on the CPU.

smollm-135m reduced (d_model 64, 4/2 heads of 8, d_ff 128, vocab 256, 2
layers).  Parameters are the JAX ``init_params`` tree with random norm
weights (zero norm weights make ``(1 + w)`` the identity and would hide a
gradient that scales by ``w``), carried across by ``params_from_jax``;
inputs are made with numpy from a seed and given to both sides.

(a) the port's ``attn_fb`` (kv_chunk 16 and 64, remat none and full),
    ``dense_fb`` and ``embed_loss_fb`` closures against ``jax.grad`` of the
    JAX study's own closures;
(b) the explicit backward formulas ``rmsnorm_bwd_ref`` and
    ``flash_attention_bwd_ref`` against ``torch.autograd`` of the forward
    plain versions and against ``jax.grad`` of the JAX layers;
(c) ``adamw_update`` against JAX's for 3 steps.

Tolerance rtol 1e-4, atol 1e-5 (as ``test_torch_models.py``): both sides do
the same f32 arithmetic in another order.  The block gradients (a) take an
atol of 1e-5 times the tensor's largest magnitude instead: the gradients of
sum(h^2) reach ~260, so an element near zero carries the rounding of sums
of terms that size (measured: at most 7e-7 of the largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models.model import Model as JaxModel
from repro.train import optim as jopt
from repro.tune.lm_study import LMStudy as JaxStudy, StepKnobs as JaxKnobs
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optim as topt
from repro_torch.tune.lm_study import LMStudy, StepKnobs

RTOL, ATOL = 1e-4, 1e-5
ARCH, BATCH, SEQ = "smollm-135m", 2, 32


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def studies():
    """(JAX study, port study) on the same weights and tokens."""
    jcfg = jax_get_config(ARCH, reduced=True)
    tree = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for sub in tree.values():
        for nm in sub:
            if nm.endswith("ln"):
                sub[nm] = (rng.standard_normal(sub[nm].shape) * 0.1
                           ).astype(np.float32)
    js = JaxStudy(ARCH, batch=BATCH, seq=SEQ)
    js.params = jax.tree.map(jnp.asarray, tree)
    ts = LMStudy(ARCH, batch=BATCH, seq=SEQ, device="cpu")
    ts.params = params_from_jax(tree, get_config(ARCH, reduced=True),
                                device="cpu")
    ts.batch_data = {k: torch.from_numpy(np.array(v))
                     for k, v in js.batch_data.items()}
    return js, ts


def _knobs(kv=32, remat="none"):
    return dict(kv_chunk=kv, remat=remat)


def _x(seed, cfg):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)


def _port_grads_match(tg, jg):
    assert set(tg) == set(jg)
    for k in tg:
        want = np.asarray(jg[k])
        scale = max(1.0, float(np.abs(want).max()))
        _close(tg[k].reshape(want.shape), want, atol=ATOL * scale)


@pytest.mark.parametrize("kv", [16, 64])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_attn_fb_grads_match_jax(studies, kv, remat):
    js, ts = studies
    kn = _knobs(kv, remat)
    _, jbuild = js._mixer_kernel("attn", 0, JaxKnobs("k", **kn), BATCH)
    _, tbuild = ts._mixer_kernel("attn", 0, StepKnobs("k", **kn), BATCH)
    jfn, (jmix, _) = jbuild()
    tfn, (tmix, _) = tbuild()
    x = _x(1, ts.cfg)
    jg = jfn(jmix, jnp.asarray(x))
    tg = tfn(tmix, torch.from_numpy(x))
    _port_grads_match(tg, jg)
    assert float(np.abs(np.asarray(jg["ln"])).max()) > 0.0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dense_fb_grads_match_jax(studies, remat):
    js, ts = studies
    kn = _knobs(remat=remat)
    _, jbuild = js._ffn_kernel("dense", 0, JaxKnobs("k", **kn), BATCH)
    _, tbuild = ts._ffn_kernel("dense", 0, StepKnobs("k", **kn), BATCH)
    jfn, (jffn, _) = jbuild()
    tfn, (tffn, _) = tbuild()
    x = _x(2, ts.cfg)
    _port_grads_match(tfn(tffn, torch.from_numpy(x)),
                      jfn(jffn, jnp.asarray(x)))


def test_embed_loss_fb_grads_match_jax(studies):
    js, ts = studies
    _, jbuild = js._embed_loss_kernel(JaxKnobs("k"), BATCH)
    _, tbuild = ts._embed_loss_kernel(StepKnobs("k"), BATCH)
    jfn, (jsub,) = jbuild()
    tfn, (tsub,) = tbuild()
    jg, tg = jfn(jsub), tfn(tsub)
    assert set(tg) == set(jg) == {"embed", "final"}
    _close(tg["embed"]["tok"], jg["embed"]["tok"])
    _close(tg["final"]["ln"], jg["final"]["ln"])


def test_cpu_gradients_take_the_explicit_backward_formulas(studies):
    _, ts = studies
    before = dict(ops.plain_calls)
    _, build = ts._mixer_kernel("attn", 0, StepKnobs("k", **_knobs(16)),
                                BATCH)
    fn, args = build()
    fn(*args)
    for k in ("rmsnorm_bwd", "flash_attention_bwd", "matmul"):
        assert ops.plain_calls[k] > before[k]


# -- (b) the backward formulas ------------------------------------------------

FLASH_SHAPES = [(2, 16, 16, 4, 2, 8), (1, 5, 12, 3, 1, 16),
                (2, 9, 9, 2, 2, 8)]


# bf16 (q, k, v, dO in bf16; the plain backward computes in f32 from them
# and rounds its outputs): JAX's bf16 vjp rounds P to bf16 before P V and
# carries bf16 cotangents, so the two differ by a couple of bf16 ulps (2^-8
# relative) of each tensor's largest magnitude (measured: at most 6.8e-3 of
# it at these shapes), hence rtol 2e-2 and atol 1.5e-2 x that magnitude
BF16_TOL = (2e-2, 1.5e-2)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_ref_matches_autograd_and_jax(shape, dtype):
    B, Sq, Skv, H, KVH, d = shape
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((B, Sq, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, KVH, d)).astype(np.float32)
            for _ in range(2))
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tdo = torch.from_numpy(do).to(tdt)
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    mine = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                       o.detach(), lse, tdo)

    def jfwd(q, k, v):
        return JL.chunked_attention(
            q, k, v, q_positions=jnp.arange(Skv - Sq, Skv),
            kv_positions=jnp.arange(Skv), causal=True, kv_chunk=Skv)
    _, vjp = jax.vjp(jfwd, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    for g, a, j in zip(mine, auto, vjp(jnp.asarray(do, jdt))):
        assert g.dtype == tdt and a.dtype == tdt
        if dtype == "float32":
            _close(g, a)
            _close(g, j)
            continue
        g, a = (x.detach().float().numpy() for x in (g, a))
        j = np.asarray(j, np.float32)
        rtol, arel = BF16_TOL
        _close(g, a, rtol=rtol, atol=arel * np.abs(a).max())
        _close(g, j, rtol=rtol, atol=arel * np.abs(j).max())


def test_rmsnorm_bwd_ref_matches_autograd_and_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    tx, tw = torch.from_numpy(x).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    auto = torch.autograd.grad(ref.rmsnorm_ref(tx, tw), (tx, tw),
                               torch.from_numpy(dy))
    mine = ref.rmsnorm_bwd_ref(tx.detach(), tw.detach(), torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda a, b: JL.rms_norm(a, b), jnp.asarray(x),
                     jnp.asarray(w))
    for g, a, j in zip(mine, auto, vjp(jnp.asarray(dy))):
        _close(g, a)
        _close(g, j)


# -- (c) AdamW ------------------------------------------------------------------

def test_adamw_update_matches_jax_for_three_steps():
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (4, 6), "b": (6,)}, "c": {"ln": (5,)}}
    params = {g: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in sub.items()} for g, sub in shapes.items()}
    cfg_kw = dict(warmup=2, decay_steps=5, clip_norm=1.0)
    jc, tc = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = topt.tree_map(torch.from_numpy, params)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(3):
        grads = {g: {k: (rng.standard_normal(s) * (3.0 if step == 0 else 0.1))
                     .astype(np.float32) for k, s in sub.items()}
                 for g, sub in shapes.items()}
        jp, js, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray,
                                                            grads), js)
        tp, ts, tm = topt.adamw_update(tc, tp, topt.tree_map(
            torch.from_numpy, grads), ts)
        for g, sub in shapes.items():
            for k in sub:
                _close(tp[g][k], jp[g][k])
                _close(ts["m"][g][k], js["m"][g][k])
                _close(ts["v"][g][k], js["v"][g][k])
        assert int(ts["step"]) == int(js["step"]) == step + 1
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])


# -- the backward kernels' plans and wrappers (plain Python) -------------------

@pytest.mark.parametrize("bk,Skv,want", [(None, 32, 32), (16, 32, 16),
                                         (64, 32, 32), (64, 2048, 64),
                                         (1024, 2048, 64), (5, 32, 16),
                                         (33, 100, 64), (64, 7, 16)])
def test_kv_tile_clamps_the_chunk_as_pallas_does(bk, Skv, want):
    from repro_torch.kernels.flash_attention import BK_TILES, kv_tile
    assert kv_tile(bk, Skv, torch.float32) == want
    assert kv_tile(None, Skv, torch.bfloat16) == 64
    assert want in BK_TILES


def test_attn_block_keeps_the_serving_tile_at_the_default_chunk(monkeypatch):
    """kv_chunk reaches the flash kernel as bk; the default passes none, so
    serving keeps its tile."""
    from repro_torch.models import layers as L
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True, bk=None):
        seen.append(bk)
        return real(q, k, v, causal=causal, bk=bk)
    monkeypatch.setattr(L.ops, "flash_attention", spy)
    cfg = get_config(ARCH, reduced=True)
    from repro_torch.models.model import init_params
    p = {k[4:]: v[0] for k, v in init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["pos0"].items()
        if k.startswith("mix_")}
    x = torch.randn(1, 8, cfg.d_model)
    pos = torch.arange(8)
    outs = [L.attn_block(p, x, cfg, positions=pos, **kw)[0]
            for kw in ({}, {"kv_chunk": 16}, {"kv_chunk": 64})]
    assert seen == [None, 16, 64]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("rows", [1, 7, 64, 65, 8192])
@pytest.mark.parametrize("D", [1, 8, 576, 4096])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_plan_covers_every_row_once(rows, D, sms, dtype):
    """The one-launch backward's plan: the forward's variant and vectors a
    thread; blocks x rows a block visit every row once (the kernels'
    grid-stride loops, walked here); the grid stops at what the SMs hold;
    a workspace row per block; groups of the two-level dw sum; a forced
    variant that cannot take the shape raises."""
    from repro_torch.kernels.rmsnorm import (
        BWD_BLOCKS_PER_SM, WARP_RED_FLOATS, plan_rmsnorm, plan_rmsnorm_bwd,
        variants_for)
    w_dtype = torch.float32
    plan = plan_rmsnorm_bwd(rows, D, D, dtype, w_dtype, sms=sms)
    fwd = plan_rmsnorm(rows, D, D, dtype, w_dtype, sms=sms)
    assert plan.variant == variants_for(D, D, dtype)[0] == fwd.variant
    assert plan.nv == fwd.nv
    if plan.variant == "warp":
        assert plan.threads == 32 * plan.rows_per_block
        assert plan.rows_per_block * D <= WARP_RED_FLOATS
    else:
        assert plan.threads == fwd.threads and plan.rows_per_block == 1
    # row = (block * rpb + warp) + k * grid * rpb, as the kernels walk them
    rpb, grid = plan.rows_per_block, plan.grid
    seen = np.zeros(rows, dtype=np.int64)
    for b in range(grid):
        for wp in range(rpb):
            seen[b * rpb + wp::grid * rpb] += 1
    assert (seen == 1).all()
    assert 1 <= grid <= -(-rows // rpb)                    # no idle block
    assert grid == min(-(-rows // rpb), sms * BWD_BLOCKS_PER_SM)
    assert plan.ws_rows == grid
    groups = -(-grid // plan.group)
    assert 1 <= plan.group <= grid
    assert plan.counters == (groups + 1 if groups > 1 else 1)
    assert tuple(plan.params) == (rows, D, D, D, D, 0 if dtype ==
                                  torch.float32 else 1, 0,
                                  {"warp": 0, "block": 1,
                                   "scalar": 2}[plan.variant],
                                  plan.nv, plan.threads, rpb, grid,
                                  plan.group)
    # forcing a variant: each one that fits is taken; one that cannot take
    # the shape (row strides that do not hold whole vectors) raises
    for v in variants_for(D, D, dtype):
        assert plan_rmsnorm_bwd(rows, D, D, dtype, w_dtype, sms=sms,
                                variant=v).variant == v
    with pytest.raises(ValueError, match="cannot take"):
        plan_rmsnorm_bwd(rows, D, D + 1, dtype, w_dtype, sms=sms,
                         variant="warp")
    with pytest.raises(ValueError, match="cannot take"):
        plan_rmsnorm_bwd(rows, D, D, dtype, w_dtype, sms=sms,
                         variant="block", dy_stride=D + 1)


def test_backward_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(x, torch.zeros(8), x)
    q = torch.ones(1, 4, 2, 8)
    kv = torch.ones(1, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, kv, kv, q, torch.zeros(1, 2, 4), q)


def test_serving_path_records_no_graph():
    """Without grad-requiring inputs, or under no_grad, the ops call the
    forward directly: no autograd node, as serving always did."""
    x = torch.randn(3, 8)
    w = torch.zeros(8, requires_grad=True)
    assert ops.rmsnorm(x, w).grad_fn is not None
    with torch.no_grad():
        assert ops.rmsnorm(x, w).grad_fn is None
    assert ops.matmul(x, torch.ones(8, 2)).grad_fn is None
