"""The flash kernels' query offset (the Pallas kernel's ``q_offset``) on the
CPU: the port's plain versions against the JAX model's attention with
global query positions, the wrappers' checks, the plans, and a sequence
split into shards against the whole call.

- ``ref.flash_attention_ref`` at an offset against
  ``repro.models.layers.chunked_attention`` with ``q_positions = q_offset
  + arange(Sq)`` (the reference's attention on sequence-sharded queries),
  and ``ref.flash_attention_bwd_ref`` against ``jax.vjp`` of it; at
  offsets 0, mid and Skv - Sq, GQA 9/3 heads of 16 and MLA's (24, 16) with
  MLA's scale.  Tolerance: forward rtol 1e-4 / atol 1e-5; gradients
  within 1e-5 x each tensor's largest magnitude (ROADMAP section 3: both
  sides do the same f32 arithmetic in another order).
- ``ops.flash_attention`` with ``q_offset`` through autograd (the plain
  versions on the CPU); the default offset's bits equal an explicit Skv -
  Sq's.
- a sequence split into shards, each run at its own offset: its output
  and dq are the whole call's rows, and the shards' dk and dv sum to the
  whole call's (1e-5 x scale).
- the wrappers refuse ``q_offset + Sq > Skv`` and a negative offset under
  causal before anything launches; the plans do not depend on the offset;
  the ctypes signatures match the C entries' arity.
"""

import ctypes
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cost import causal_pairs

fa = importlib.import_module("repro_torch.kernels.flash_attention")
CSRC = Path(fa.__file__).resolve().parent / "csrc"

# (B, Sq, Skv, H, KVH, dk, dv, scale)
GQA = (2, 8, 24, 9, 3, 16, 16, None)
MLA = (2, 8, 24, 4, 4, 24, 16, 0.7 / np.sqrt(24))
FWD_TOL = (1e-4, 1e-5)
GRAD_REL = 1e-5


def _offsets(dims):
    Sq, Skv = dims[1], dims[2]
    return (0, (Skv - Sq) // 2, Skv - Sq)


CASES = [(dims, off) for dims in (GQA, MLA) for off in _offsets(dims)]
IDS = [f"{'gqa' if d is GQA else 'mla'}-off{o}" for d, o in CASES]


def _inputs(dims, seed):
    B, Sq, Skv, H, KVH, dk, dv, _ = dims
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, dk), (B, Skv, KVH, dk), (B, Skv, KVH, dv), (B, Sq, H, dv))]


def _jax_attention(dims, off):
    Sq, Skv, scale = dims[1], dims[2], dims[7]

    def f(q, k, v):
        return chunked_attention(q, k, v, q_positions=off + jnp.arange(Sq),
                                 kv_positions=jnp.arange(Skv), causal=True,
                                 kv_chunk=8, softmax_scale=scale)
    return f


def _within_scale(got, want, rel=GRAD_REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("dims,off", CASES, ids=IDS)
def test_plain_forward_at_an_offset_matches_chunked_attention(dims, off):
    q, k, v, _ = _inputs(dims, 11)
    want = _jax_attention(dims, off)(*map(jnp.asarray, (q, k, v)))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  scale=dims[7], q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FWD_TOL[0], atol=FWD_TOL[1])


@pytest.mark.parametrize("dims,off", CASES, ids=IDS)
def test_plain_backward_at_an_offset_matches_jax_vjp(dims, off):
    """``flash_attention_bwd_ref`` from the saved lse, and autograd of
    ``ops.flash_attention`` at the offset (which takes it on the CPU),
    against ``jax.vjp`` of the reference's attention."""
    q, k, v, do = _inputs(dims, 12)
    scale = dims[7]
    _, vjp = jax.vjp(_jax_attention(dims, off),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True,
                                     scale=scale, q_offset=off)
    mine = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                       scale=scale, q_offset=off)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    plain = dict(ops.plain_calls)
    out = ops.flash_attention(*leaves, scale=scale, q_offset=off)
    auto = torch.autograd.grad(out, leaves, tdo)
    assert ops.plain_calls["flash_attention"] == \
        plain["flash_attention"] + 1
    assert ops.plain_calls["flash_attention_bwd"] == \
        plain["flash_attention_bwd"] + 1
    for g, a, w in zip(mine, auto, want):
        _within_scale(g, w)
        assert torch.equal(g, a)
    # keys past the last query's position get no gradient
    Sq = dims[1]
    assert not mine[1][:, off + Sq:].any()
    assert not mine[2][:, off + Sq:].any()


@pytest.mark.parametrize("dims", [GQA, MLA], ids=["gqa", "mla"])
def test_default_offset_is_the_suffix_bit_for_bit(dims):
    q, k, v, do = map(torch.from_numpy, _inputs(dims, 13))
    Sq, Skv, scale = dims[1], dims[2], dims[7]
    o1, l1 = ref.flash_attention_ref(q, k, v, return_lse=True, scale=scale)
    o2, l2 = ref.flash_attention_ref(q, k, v, return_lse=True, scale=scale,
                                     q_offset=Skv - Sq)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    g1 = ref.flash_attention_bwd_ref(q, k, v, o1, l1, do, scale=scale)
    g2 = ref.flash_attention_bwd_ref(q, k, v, o1, l1, do, scale=scale,
                                     q_offset=Skv - Sq)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("dims", [GQA, MLA], ids=["gqa", "mla"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shards_at_their_offsets_are_the_whole_call(dims, shards):
    """A causal sequence of S split into shards of S / m queries, each run
    against every key at offset r S / m: its output and dq are the whole
    call's rows, the shards' dk and dv sum to the whole call's.  The
    heaviest shard is the last, whose offset is the default's."""
    B, _, S, H, KVH, dk, dv, scale = dims
    q, _, _, do = _inputs((B, S) + dims[2:], 14)
    _, k, v, _ = _inputs(dims, 15)
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, scale=scale)
    dq, dkw, dvw = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                               scale=scale)
    n = S // shards
    sum_dk, sum_dv = torch.zeros_like(dkw), torch.zeros_like(dvw)
    for r in range(shards):
        rows = slice(r * n, (r + 1) * n)
        os_, ls = ref.flash_attention_ref(q[:, rows], k, v, return_lse=True,
                                          scale=scale, q_offset=r * n)
        torch.testing.assert_close(os_, o[:, rows], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ls, lse[:, :, rows], rtol=1e-5,
                                   atol=1e-6)
        g = ref.flash_attention_bwd_ref(q[:, rows], k, v, os_, ls,
                                        do[:, rows], scale=scale,
                                        q_offset=r * n)
        _within_scale(g[0], dq[:, rows].numpy())
        assert not g[1][:, (r + 1) * n:].any()
        sum_dk += g[1]
        sum_dv += g[2]
    _within_scale(sum_dk, dkw.numpy())
    _within_scale(sum_dv, dvw.numpy())
    pairs = [causal_pairs(n, S, r * n) for r in range(shards)]
    assert sum(pairs) == causal_pairs(S, S)
    assert max(pairs) == pairs[-1] == causal_pairs(n, S)


@pytest.mark.parametrize("off,Sq,Skv", [(17, 8, 24), (-1, 8, 24),
                                        (0, 25, 24)])
def test_offsets_past_the_keys_are_refused(off, Sq, Skv):
    """Under causal, q_offset + Sq > Skv or q_offset < 0 raises in the plain
    version and in both wrappers, before the wrappers look at the device
    (CPU tensors here: the shape check comes first)."""
    q = torch.zeros(1, Sq, 2, 16)
    k = torch.zeros(1, Skv, 1, 16)
    with pytest.raises(ValueError, match="q_offset"):
        ref.flash_attention_ref(q, k, k, q_offset=off)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_cuda(q, k, k, q_offset=off)
    lse = torch.zeros(1, 2, Sq)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_bwd_cuda(q, k, k, q, lse, q, q_offset=off)
    # without causal the offset is not read
    assert ref.flash_attention_ref(q, k, k, causal=False,
                                   q_offset=off).shape == q.shape


def test_wrapper_shape_check_returns_the_offset():
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 24, 2, 16)
    assert fa._check_shapes(q, k, k, True) == 16
    assert fa._check_shapes(q, k, k, True, 0) == 0
    assert fa._check_shapes(q, k, k, True, 16) == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", [(64, 64), (192, 128), (24, 16)])
def test_plans_do_not_depend_on_the_offset(dtype, pair):
    """A shard's call and the default call of the same shapes share their
    plans (the offset reaches the kernel alone), and a default call keeps
    the plan it had: the caches are keyed on shapes, tile and alignment."""
    dk, dv = pair
    q = torch.zeros(2, 32, 8, dk, dtype=dtype)
    k = torch.zeros(2, 128, 4, dk, dtype=dtype)
    v = torch.zeros(2, 128, 4, dv, dtype=dtype)
    o = torch.zeros(2, 32, 8, dv, dtype=dtype)
    assert fa.plan_flash(q, k, v, 64) is fa.plan_flash(q, k, v, 64)
    bwd = fa.plan_flash_bwd(q, k, v, o, o, 64)
    assert bwd is fa.plan_flash_bwd(q, k, v, o, o, 64)
    assert (bwd.Sq, bwd.Skv, bwd.kv_blocks) == (32, 128, bwd.splits * (
        -(-128 // bwd.tile)))


@pytest.mark.parametrize("entry,argtypes", [
    ("flash_attention", fa._ARGTYPES),
    ("flash_attention_bwd", fa._BWD_ARGTYPES)])
def test_ctypes_signatures_match_the_c_entries(entry, argtypes):
    """The wrappers' ctypes argument lists have the C entries' arity, with
    q_off an int64 right after DV."""
    src = (CSRC / f"{entry}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                  re.S)
    params = [p.split()[-1].strip("*") for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    i = params.index("q_off")
    assert params[i - 1] == "DV"
    assert argtypes[i] is ctypes.c_int64
