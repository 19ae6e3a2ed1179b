"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  No JAX here, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes: the JAX test sweep's (tests/test_kernels.py), plus the serving
path's full-width ones (smollm-135m: d_model 576, 9/3 heads of 64, the
49152-wide tied head read through a transposed view), at its tolerances.
"""

import ctypes
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

MATMUL_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 96, 32), (8, 8, 8),
                 (512, 128, 256)]
RMSNORM_SHAPES = [(4, 64, 128), (3, 37, 96), (1, 1, 8), (2, 200, 256)]
FLASH_DIMS = [(2, 128, 128, 4, 2, 64),     # square causal GQA
              (1, 64, 256, 8, 8, 32),      # suffix queries (Sq < Skv)
              (2, 256, 256, 6, 2, 64),     # multi-tile both ways
              (1, 96, 96, 3, 1, 16)]       # MQA, non-128 sizes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def _dev(a: np.ndarray, dtype, device):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", MATMUL_SHAPES + [(1, 576, 576),
                                                 (4, 576, 49152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_kernel_matches_plain(cuda_device, mkn, dtype):
    M, K, N = mkn
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    a = _dev(rng.standard_normal((M, K), np.float32), tdt, cuda_device)
    b = _dev(rng.standard_normal((K, N), np.float32), tdt, cuda_device)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    n0 = ops.launches["matmul"]
    got = ops.matmul(a, b)
    bt = b.T.contiguous().T          # the tied head's strided B
    got_t = ops.matmul(a, bt)
    torch.cuda.synchronize()
    assert ops.launches["matmul"] == n0 + 2
    want = _np(ref.matmul_ref(a, b))
    for g in (got, got_t):
        np.testing.assert_allclose(_np(g), want, rtol=tol,
                                   atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMSNORM_SHAPES + [(4, 1, 576),
                                                    (1, 32, 576)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = _dev(rng.standard_normal(shape, np.float32), tdt, cuda_device)
    w = _dev((rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32),
             tdt, cuda_device)
    n0 = ops.launches["rmsnorm"]
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == n0 + 1
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(x, w)),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_DIMS + [(1, 37, 37, 9, 3, 64),
                                               (2, 33, 70, 4, 2, 8),
                                               (1, 5, 5, 2, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda_device, dims, dtype):
    B, Sq, Skv, H, KVH, d = dims
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    q = _dev(rng.standard_normal((B, Sq, H, d), np.float32), tdt, cuda_device)
    k = _dev(rng.standard_normal((B, Skv, KVH, d), np.float32), tdt,
             cuda_device)
    v = _dev(rng.standard_normal((B, Skv, KVH, d), np.float32), tdt,
             cuda_device)
    n0 = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + 1
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    want = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol)


# -- the redesigned matmul: both paths, both B layouts, edges ----------------

SKINNY_M = [1, 4, 31, "threshold", "threshold+1"]
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576),   # projections
           (576, 1), (577, 576)]                               # N = 1, K = 577


def _m_value(m, dtype, K, N):
    from repro_torch.kernels.matmul import skinny_max_m
    t = skinny_max_m(K, N, dtype)
    return {"threshold": t, "threshold+1": t + 1}.get(m, m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", SKINNY_M)
@pytest.mark.parametrize("kn", MAIN_KN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_paths_match_plain(cuda_device, m, kn, dtype):
    """Each M around the skinny threshold against the plain version, with B
    row-major (the projections) and read along K (the tied head's embed.T),
    and each output bit-identical on a repeat call (split-K sums its
    partials in a fixed order)."""
    tdt = DTYPES[dtype]
    K, N = kn
    M = _m_value(m, tdt, K, N)
    rng = np.random.default_rng(11)
    a = _dev(rng.standard_normal((M, K), np.float32), tdt, cuda_device)
    b = _dev(rng.standard_normal((K, N), np.float32) / np.sqrt(K), tdt,
             cuda_device)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    want = _np(ref.matmul_ref(a, b))
    for bb in (b, b.T.contiguous().T):
        n0 = ops.launches["matmul"]
        got, again = ops.matmul(a, bb), ops.matmul(a, bb)
        torch.cuda.synchronize()
        assert ops.launches["matmul"] == n0 + 2
        assert torch.equal(got, again)
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(4, 576, 49152), (1, 576, 49152),
                                 (2048, 576, 1536), (2048, 1536, 576),
                                 (300, 577, 129), (1, 1, 1), (3, 7, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_large_and_tiny_shapes(cuda_device, mkn, dtype):
    """The tied head, the tiled path's timing shapes and tiny ragged ones,
    with B as embed.T for the head, bit-identical on a repeat call.  B is
    scaled by 1/sqrt(K), as the model's weights are, so that f32's order
    of summation stays inside the tolerance at K = 1536."""
    M, K, N = mkn
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    a = _dev(rng.standard_normal((M, K), np.float32), tdt, cuda_device)
    b = _dev(rng.standard_normal((N, K), np.float32) / np.sqrt(K), tdt,
             cuda_device).T
    if N != 49152:
        b = b.contiguous()
    got, again = ops.matmul(a, b), ops.matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(ref.matmul_ref(a, b)),
                               rtol=tol, atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_misaligned_takes_scalar_loads(cuda_device, M, dtype):
    """Views one element off 16-byte alignment take the scalar-load
    variant of either path and still agree with the plain version."""
    from repro_torch.kernels.matmul import plan_for
    K, N = 96, 72
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    abuf = _dev(rng.standard_normal(M * K + 1, np.float32), tdt, cuda_device)
    bbuf = _dev(rng.standard_normal(K * N + 1, np.float32), tdt, cuda_device)
    a, b = abuf[1:].view(M, K), bbuf[1:].view(K, N)
    assert not plan_for(a, b).vec
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(ref.matmul_ref(a, b)),
                               rtol=tol, atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("colb", [False, True])
def test_matmul_rejects_a_plan_with_other_tiles(cuda_device, colb):
    """The split-K counters are sized from the plan's tile count: a plan
    whose tile count or width differs from the kernel's own fails the
    launch instead of writing past the counters."""
    from repro_torch.kernels.matmul import matmul_cuda, plan_for
    K, N = 1536, 576
    a = torch.randn(4, K, device=cuda_device)
    b = torch.randn(N, K, device=cuda_device).T if colb else \
        torch.randn(K, N, device=cuda_device)
    plan = plan_for(a, b)
    assert plan.path == "skinny" and plan.splits > 1
    for i in (15, 16):
        bad = replace(plan, params=(ctypes.c_int64 * len(plan.params))(
            *plan.params))
        bad.params[i] += 1
        with pytest.raises(RuntimeError, match="launch failed"):
            matmul_cuda(a, b, bad)
    torch.testing.assert_close(matmul_cuda(a, b, plan), ref.matmul_ref(a, b),
                               rtol=1e-5, atol=8e-5)


# -- the redesigned flash attention ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 64, 64, 4, 4, 128),      # G = 1
                                  (1, 37, 37, 9, 3, 128),      # G = 3
                                  (2, 50, 50, 16, 2, 128),     # G = 8
                                  (1, 1, 77, 9, 3, 64),        # Sq = 1
                                  (1, 20, 300, 8, 1, 128),     # Sq < Skv
                                  (1, 2048, 2048, 9, 3, 64),   # S = 2048
                                  (1, 33, 33, 72, 1, 32)])     # G > 64 rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grouped_heads(cuda_device, dims, dtype):
    B, Sq, Skv, H, KVH, d = dims
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(14)
    q = _dev(rng.standard_normal((B, Sq, H, d), np.float32), tdt, cuda_device)
    k = _dev(rng.standard_normal((B, Skv, KVH, d), np.float32), tdt,
             cuda_device)
    v = _dev(rng.standard_normal((B, Skv, KVH, d), np.float32), tdt,
             cuda_device)
    got, again = (ops.flash_attention(q, k, v, causal=True),
                  ops.flash_attention(q, k, v, causal=True))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    want = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_misaligned_and_strided(cuda_device, dtype):
    """k/v one element off alignment (the scalar-load variant) and q as a
    strided slice of a wider tensor (the cp.async variant)."""
    from repro_torch.kernels.flash_attention import plan_flash
    B, S, H, KVH, d = 1, 45, 6, 2, 32
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(15)
    q = _dev(rng.standard_normal((B, S, 2 * H, d), np.float32), tdt,
             cuda_device)[:, :, :H]
    n = B * S * KVH * d
    kbuf = _dev(rng.standard_normal(2 * n + 1, np.float32), tdt, cuda_device)
    k = kbuf[1:n + 1].view(B, S, KVH, d)
    v = kbuf[n + 1:].view(B, S, KVH, d)
    assert not plan_flash(q, k, v).vec
    assert plan_flash(q, k.clone(), v.clone()).vec
    want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    for kk, vv in ((k, v), (k.clone(), v.clone())):
        got = ops.flash_attention(q, kk, vv, causal=True)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- the redesigned RMSNorm: every variant, strides, alignment, w dtypes ------

RMS_D = [8, 96, 576, 577, 4096, 7168]


def _rms_cases():
    """(D, x dtype, variant) for each variant that can take D (plain
    Python: the plan's own rule, no card needed to list them)."""
    from repro_torch.kernels.rmsnorm import variants_for
    return [(D, dn, v) for D in RMS_D for dn, t in DTYPES.items()
            for v in variants_for(D, D, t)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _rms_cases())
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_rmsnorm_variants_match_plain(cuda_device, case, w_dtype):
    """Each variant forced at each D it takes, with w in either dtype
    (read in its own, never converted), one launch a call, the same bits
    on a repeat call."""
    from repro_torch.kernels.rmsnorm import plan_for, rmsnorm_cuda
    D, dtype, variant = case
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(16)
    x = _dev(rng.standard_normal((5, D), np.float32), tdt, cuda_device)
    w = _dev((rng.standard_normal(D) * 0.1).astype(np.float32),
             DTYPES[w_dtype], cuda_device)
    plan = plan_for(x, w, variant)
    assert plan.variant == variant
    n0 = ops.launches["rmsnorm"]
    got, again = rmsnorm_cuda(x, w, plan=plan), rmsnorm_cuda(x, w, plan=plan)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == n0 + 2
    assert torch.equal(got, again)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(x, w)),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 576, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_strided_and_misaligned(cuda_device, D, dtype):
    """x as a strided view (big[:, :D], read in place by the vector
    variants) and as a view one element off 16-byte alignment (the scalar
    variant), and a strided w."""
    from repro_torch.kernels.rmsnorm import plan_for
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    big = _dev(rng.standard_normal((7, 2 * D + 16), np.float32), tdt,
               cuda_device)
    buf = _dev(rng.standard_normal(7 * D + 1, np.float32), tdt, cuda_device)
    w2 = _dev((rng.standard_normal(2 * D) * 0.1).astype(np.float32), tdt,
              cuda_device)
    strided, off = big[:, :D], buf[1:].view(7, D)
    assert plan_for(strided, w2[::2].contiguous()).variant != "scalar"
    assert plan_for(off, w2[::2].contiguous()).variant == "scalar"
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    for x in (strided, off):
        for w in (w2[::2], w2[1::2].contiguous()):
            got = ops.rmsnorm(x, w)
            torch.cuda.synchronize()
            np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(x, w)),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
def test_rmsnorm_rejects_a_plan_with_other_geometry(cuda_device):
    """A plan whose vectors a thread, threads or rows a block differ from
    what the kernel derives, or whose vector variant meets a misaligned
    pointer, fails the launch instead of reading past the row."""
    from repro_torch.kernels.rmsnorm import plan_for, rmsnorm_cuda
    x = torch.randn(4, 576, device=cuda_device)
    w = torch.randn(576, device=cuda_device) * 0.1
    plan = plan_for(x, w)
    assert plan.variant == "warp"
    for i, step in ((7, 1), (8, 32), (9, 1), (6, 1)):
        bad = replace(plan, params=(ctypes.c_int64 * len(plan.params))(
            *plan.params))
        bad.params[i] += step
        with pytest.raises(RuntimeError, match="launch failed"):
            rmsnorm_cuda(x, w, plan=bad)
    buf = torch.randn(4 * 576 + 4, device=cuda_device)
    off = buf[1:4 * 576 + 1].view(4, 576)       # 4 bytes off 16
    assert plan_for(off, w).variant == "scalar"
    with pytest.raises(RuntimeError, match="launch failed"):
        rmsnorm_cuda(off, w, plan=plan)
    with pytest.raises(ValueError, match="other tensors"):
        rmsnorm_cuda(x[:3], w, plan=plan)
    torch.testing.assert_close(rmsnorm_cuda(x, w, plan=plan),
                               ref.rmsnorm_ref(x, w), rtol=2e-5, atol=2e-5)


# -- gradients: the backward kernels and the autograd paths ------------------

# (B, Sq, Skv, H, KVH, d): S not a multiple of the tile, Sq < Skv, G = 1
# and G > 1, every head width; the tuning loop's full-width shapes
FLASH_BWD_DIMS = [(1, 37, 37, 9, 3, 64), (2, 5, 12, 4, 2, 16),
                  (1, 33, 70, 4, 4, 8), (2, 96, 96, 8, 2, 32),
                  (1, 20, 20, 2, 1, 128), (2, 32, 32, 9, 3, 64),
                  (1, 32, 32, 9, 3, 64),
                  # Skv >= 64 at d 128 and d 16, so that the kv_tile
                  # clamp leaves every (dtype, d, tile) instantiation run
                  (1, 80, 80, 4, 2, 128), (2, 70, 70, 4, 2, 16)]
BWD_TOL = (1e-4, 1e-4)     # f32 sums in another order than the plain version
# bf16: the kernel rounds P and dS to bf16 (8 significant bits) before their
# products, as FlashAttention-2 does, where the plain version keeps them in
# f32; both round the outputs.  So an element may differ by a few of its
# own ulps (2^-8 relative: rtol 2e-2) plus the rounding of P and dS summed
# over the rows or keys, which is relative to the tensor's largest
# magnitude (atol 1e-2 x that; measured on the card: under 6e-3)
BWD_TOL_BF16 = (2e-2, 1e-2)


def _flash_inputs(dims, device, seed, dtype=torch.float32):
    B, Sq, Skv, H, KVH, d = dims
    rng = np.random.default_rng(seed)
    mk = lambda *s: _dev(rng.standard_normal(s, np.float32),  # noqa: E731
                         dtype, device)
    return mk(B, Sq, H, d), mk(B, Skv, KVH, d), mk(B, Skv, KVH, d), \
        mk(B, Sq, H, d)


def _check_flash_bwd(got, want, dtype):
    """Each of dq, dk, dv against the plain version at its dtype's
    tolerance (bf16: atol relative to the tensor's largest magnitude)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if dtype == "bfloat16":
            rtol, arel = BWD_TOL_BF16
            atol = arel * float(w.float().abs().max())
        else:
            rtol, atol = BWD_TOL
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_BWD_DIMS)
@pytest.mark.parametrize("bk", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, dims, bk,
                                                  dtype):
    """Forward with lse at KV tile bk, then dq/dk/dv through the autograd
    path, against the plain backward; two runs give the same bits; the
    autograd path launches both kernels and calls no plain version."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    tdt = DTYPES[dtype]
    q, k, v, do = _flash_inputs(dims, cuda_device, 21, tdt)
    o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True)
    # the forward's own tolerances (test_flash_attention_forward_tiles_...)
    otol, ltol = (4e-2, 4e-2) if dtype == "bfloat16" else (3e-4, 1e-5)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=otol,
                               atol=otol)
    torch.testing.assert_close(lse, lse_ref, rtol=ltol, atol=ltol)
    n0 = ops.launches["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == n0 + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _check_flash_bwd(got, want, dtype)
    # the autograd Function: forward and backward both on the card
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, p1 = dict(ops.launches), dict(ops.plain_calls)
    out = ops.flash_attention(*leaves, bk=bk)
    grads = torch.autograd.grad(out, leaves, do)
    assert ops.launches["flash_attention"] == n1["flash_attention"] + 1
    assert ops.launches["flash_attention_bwd"] == \
        n1["flash_attention_bwd"] + 1
    assert ops.plain_calls == p1
    _check_flash_bwd(grads, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_splits_key_tiles(cuda_device, dtype):
    """A long prompt: the plan cuts each key tile's rows over several
    dK/dV blocks, summed in split order by the last to arrive; the same
    bits twice, and the counters back at zero between calls."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        bwd_scratch, flash_attention_bwd_cuda, flash_attention_cuda,
        plan_flash_bwd)
    tdt = DTYPES[dtype]
    q, k, v, do = _flash_inputs((1, 512, 512, 6, 2, 64), cuda_device, 27,
                                tdt)
    o, lse = flash_attention_cuda(q, k, v, bk=64, with_lse=True)
    plan = plan_flash_bwd(q, k, v, o, do, 64)
    assert plan.splits > 1 and plan.vec
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=64)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=64)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _check_flash_bwd(got, ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                     dtype)
    # twice the splits, the dK/dV block count to match: the wrapper sizes
    # the workspace from the splits it passes, so the plan runs and agrees
    from dataclasses import replace as dc_replace
    more = dc_replace(plan, splits=2 * plan.splits,
                      kv_blocks=2 * plan.kv_blocks)
    _check_flash_bwd(flash_attention_bwd_cuda(q, k, v, o, lse, do, plan=more),
                     ref.flash_attention_bwd_ref(q, k, v, o, lse, do), dtype)
    counters = bwd_scratch(1, 2, 512, plan.tile, more.splits, 64)[1]
    _, cnt = _build.scratch(q.device, _build.stream(), 0, counters)
    assert int(cnt[:counters].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_misaligned_and_strided(cuda_device, dtype):
    """k/v one element off alignment and q, dO strided slices of wider
    tensors: the element-load path, against the plain version; the same
    views made contiguous take cp.async."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_flash_bwd)
    B, S, H, KVH, d = 1, 45, 6, 2, 32
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(28)
    q = _dev(rng.standard_normal((B, S, 2 * H, d), np.float32), tdt,
             cuda_device)[:, :, :H]
    do = _dev(rng.standard_normal((B, S, 2 * H, d), np.float32), tdt,
              cuda_device)[:, :, H:]
    n = B * S * KVH * d
    kbuf = _dev(rng.standard_normal(2 * n + 1, np.float32), tdt, cuda_device)
    k = kbuf[1:n + 1].view(B, S, KVH, d)
    v = kbuf[n + 1:].view(B, S, KVH, d)
    for bk in (16, 64):
        o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
        assert not plan_flash_bwd(q, k, v, o, do, bk).vec
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk)
        _check_flash_bwd(got, want, dtype)
        kc, vc = k.clone(), v.clone()
        assert plan_flash_bwd(q, kc, vc, o, do, bk).vec
        _check_flash_bwd(flash_attention_bwd_cuda(q, kc, vc, o, lse, do,
                                                  bk=bk), want, dtype)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [None, 16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_forward_tiles_match_plain(cuda_device, bk, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    tdt = DTYPES[dtype]
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    for dims in ((1, 37, 37, 9, 3, 64), (2, 33, 70, 4, 2, 8),
                 (1, 100, 100, 4, 1, 128)):
        q, k, v, _ = (t.to(tdt) for t in _flash_inputs(dims, cuda_device, 22))
        o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True)
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, lse_ref, rtol=tol, atol=tol)
        # lse or not, and the serving call, give the same output
        assert torch.equal(o, flash_attention_cuda(q, k, v, bk=bk))


@pytest.mark.cuda
def test_flash_attention_bwd_rejects_what_it_cannot_run(cuda_device):
    from dataclasses import replace as dc_replace
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_flash_bwd)
    q, k, v, do = _flash_inputs((1, 37, 37, 9, 3, 64), cuda_device, 23)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True)
    for tile in (8, 48, 128):      # not an instantiated tile
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_attention_bwd_cuda(
                q, k, v, o, lse, do,
                plan=dc_replace(plan_flash_bwd(q, k, v, o, do), tile=tile))
    # f16, and mixed dtypes, raise: no fallback
    with pytest.raises(TypeError):
        h = [t.half() for t in (q, k, v, o, do)]
        flash_attention_bwd_cuda(*h[:4], lse, h[4])
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, k.bfloat16(), v, o, lse, do)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, v, o, lse[:, :, :-1], do)
    # a plan that is not the C entry's own is refused before any launch
    plan = plan_flash_bwd(q, k, v, o, do)
    n0 = ops.launches["flash_attention_bwd"]
    for bad in (dc_replace(plan, warps=plan.warps * 2),
                dc_replace(plan, rows=plan.rows // 2),
                dc_replace(plan, q_blocks=plan.q_blocks + 1),
                dc_replace(plan, kv_blocks=plan.kv_blocks + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_attention_bwd_cuda(q, k, v, o, lse, do, plan=bad)
    off = torch.empty(k.numel() + 4, device=cuda_device)[1:k.numel() + 1]
    off = off.view(k.shape).copy_(k)
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention_bwd_cuda(q, off, v, o, lse, do, plan=plan)
    assert ops.launches["flash_attention_bwd"] == n0
    _check_flash_bwd(flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                              plan=plan),
                     ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                     "float32")


RMS_BWD_SHAPES = [(64, 576), (32, 576), (37, 577), (3, 7168), (1, 8),
                  (2, 5, 96)]


def _rms_bwd_inputs(shape, dtype, w_dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = _dev(rng.standard_normal(shape, np.float32), dtype, device)
    dy = _dev(rng.standard_normal(shape, np.float32), dtype, device)
    w = _dev((rng.standard_normal(shape[-1]) * 0.1).astype(np.float32),
             w_dtype, device)
    return x, w, dy


def _check_rms_bwd(got, want, bf16):
    """dx within the kernels' tolerance; dw sums a column over the rows, so
    its atol scales with its largest magnitude."""
    tol = 3e-2 if bf16 else 1e-4
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    scale = max(1.0, float(want[1].float().abs().max()))
    torch.testing.assert_close(got[1].float(), want[1].float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape, dtype,
                                          w_dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    tdt = DTYPES[dtype]
    x, w, dy = _rms_bwd_inputs(shape, tdt, DTYPES[w_dtype], cuda_device, 24)
    n0 = ops.launches["rmsnorm_bwd"]
    dx, dw = rmsnorm_bwd_cuda(x, w, dy)
    dx2, dw2 = rmsnorm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm_bwd"] == n0 + 2
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == tdt and dw.dtype == w.dtype
    _check_rms_bwd((dx, dw), ref.rmsnorm_bwd_ref(x, w, dy),
                   "bfloat16" in (dtype, w_dtype))


# rows well above the grid (8192: many blocks, two levels of the dw sum)
RMS_BWD_VARIANT_SHAPES = [(64, 576), (37, 577), (3, 7168), (1, 8), (10, 96),
                          (8192, 576), (300, 4096)]


def _rms_bwd_cases():
    """(shape, x dtype, variant) for each variant that can take the shape
    (plain Python: the plan's own rule, no card needed to list them)."""
    from repro_torch.kernels.rmsnorm import variants_for
    return [(s, dn, v) for s in RMS_BWD_VARIANT_SHAPES
            for dn, t in DTYPES.items() for v in variants_for(s[1], s[1], t)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _rms_bwd_cases())
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_variants_match_plain(cuda_device, case, w_dtype):
    """Each backward variant forced on each shape it takes: one launch a
    call, the same bits on a repeat, within tolerance of the plain
    version."""
    from repro_torch.kernels.rmsnorm import bwd_plan_for, rmsnorm_bwd_cuda
    shape, dtype, variant = case
    x, w, dy = _rms_bwd_inputs(shape, DTYPES[dtype], DTYPES[w_dtype],
                               cuda_device, 27)
    plan = bwd_plan_for(x, w, dy, variant)
    assert plan.variant == variant
    n0 = ops.launches["rmsnorm_bwd"]
    got = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
    again = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm_bwd"] == n0 + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _check_rms_bwd(got, ref.rmsnorm_bwd_ref(x, w, dy),
                   "bfloat16" in (dtype, w_dtype))


@pytest.mark.cuda
def test_rmsnorm_bwd_same_bits_after_another_shape(cuda_device):
    """The cached workspace and counters: a call of another shape (another
    grid, one level of the dw sum or two) between two calls leaves the
    result's bits unchanged, and every call leaves the counters at zero."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import bwd_plan_for, rmsnorm_bwd_cuda
    f32 = torch.float32
    a = _rms_bwd_inputs((64, 576), f32, f32, cuda_device, 28)
    b = _rms_bwd_inputs((8192, 576), f32, f32, cuda_device, 29)
    c = _rms_bwd_inputs((37, 577), f32, f32, cuda_device, 30)
    assert bwd_plan_for(*a).counters == 1
    assert bwd_plan_for(*b).counters > 2
    firsts = [rmsnorm_bwd_cuda(*args) for args in (a, b, c)]
    for args, first in zip((a, b, c, b, a), firsts + firsts[1::-1]):
        got = rmsnorm_bwd_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
        _, cnt = _build._scratch[(cuda_device.index or 0,
                                  _build.stream())]
        assert int(cnt.count_nonzero()) == 0
    for args, got in zip((a, b, c), firsts):
        _check_rms_bwd(got, ref.rmsnorm_bwd_ref(*args), False)


@pytest.mark.cuda
def test_rmsnorm_bwd_strided_and_tampered(cuda_device):
    """Strided rows of x and dy read in place; a plan whose geometry
    differs from what the kernel derives, or whose vector variant meets a
    misaligned pointer, fails before anything is launched (and the next
    call is still right)."""
    from repro_torch.kernels.rmsnorm import bwd_plan_for, rmsnorm_bwd_cuda
    big = torch.randn(9, 1200, device=cuda_device)
    x, dy = big[:, :577], big[:, 600:1177]          # strided rows
    w = torch.randn(577, device=cuda_device) * 0.1
    dx, dw = rmsnorm_bwd_cuda(x, w, dy)
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy)
    torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-4)
    x, dy = big[:, :576], big[:, 600:1176]          # strided, aligned
    w = w[:576].contiguous()
    plan = bwd_plan_for(x, w, dy)
    assert plan.variant == "warp"
    n0 = ops.launches["rmsnorm_bwd"]
    # params: 7 variant, 8 nv, 9 threads, 10 rows a block, 11 grid, 12 group
    for i, step in ((7, 1), (8, 1), (9, 32), (10, 1), (11, -plan.grid),
                    (12, plan.grid), (12, -plan.group)):
        bad = replace(plan, params=(ctypes.c_int64 * len(plan.params))(
            *plan.params))
        bad.params[i] += step
        with pytest.raises(RuntimeError, match="launch failed"):
            rmsnorm_bwd_cuda(x, w, dy, plan=bad)
    buf = torch.randn(9 * 576 + 4, device=cuda_device)
    off = buf[1:9 * 576 + 1].view(9, 576)           # 4 bytes off 16
    assert bwd_plan_for(off, w, dy).variant == "scalar"
    with pytest.raises(RuntimeError, match="launch failed"):
        rmsnorm_bwd_cuda(off, w, dy, plan=bwd_plan_for(off.clone(), w, dy))
    with pytest.raises(ValueError, match="other tensors"):
        rmsnorm_bwd_cuda(x[:3], w, dy[:3], plan=plan)
    assert ops.launches["rmsnorm_bwd"] == n0
    got = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
    _check_rms_bwd(got, ref.rmsnorm_bwd_ref(x, w, dy), False)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(64, 576, 576), (64, 576, 1536),
                                 (64, 1536, 576), (32, 576, 192),
                                 (37, 100, 51)])
def test_matmul_backward_on_transposed_views(cuda_device, mkn):
    """dA = dC B^T and dB = A^T dC through the forward kernel on
    transposed views (A^T has unit stride along its rows)."""
    M, K, N = mkn
    rng = np.random.default_rng(25)
    a = _dev(rng.standard_normal((M, K), np.float32), torch.float32,
             cuda_device).requires_grad_()
    b = _dev((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
             torch.float32, cuda_device).requires_grad_()
    dc = _dev(rng.standard_normal((M, N), np.float32), torch.float32,
              cuda_device)
    n0 = ops.launches["matmul"]
    da, db = torch.autograd.grad(ops.matmul(a, b), (a, b), dc)
    torch.cuda.synchronize()
    assert ops.launches["matmul"] == n0 + 3
    torch.testing.assert_close(da, ref.matmul_ref(dc, b.detach().T),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, ref.matmul_ref(a.detach().T, dc),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_tied_head_backward(cuda_device):
    """The tied head's products at the tuning loop's width: logits = x
    embed^T with embed (49152, 576) read through a transposed view."""
    rng = np.random.default_rng(26)
    x = _dev(rng.standard_normal((64, 576), np.float32), torch.float32,
             cuda_device).requires_grad_()
    emb = _dev((rng.standard_normal((49152, 576)) * 0.02).astype(np.float32),
               torch.float32, cuda_device).requires_grad_()
    dc = _dev(rng.standard_normal((64, 49152), np.float32) * 1e-3,
              torch.float32, cuda_device)
    dx, demb = torch.autograd.grad(ops.matmul(x, emb.T), (x, emb), dc)
    torch.testing.assert_close(dx, ref.matmul_ref(dc, emb.detach()),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(demb, ref.matmul_ref(x.detach().T, dc).T,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["attn16", "attn64", "dense", "embed"])
def test_study_thunk_grads_match_cpu_port(cuda_device, kind):
    """A CUDA ``LMStudy`` kernel's gradients against the port's CPU run on
    the same weights (random norm weights) and inputs, reduced smollm."""
    from repro_torch.tune.lm_study import LMStudy, StepKnobs
    studies = [LMStudy("smollm-135m", device=d) for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(9)
    for grp, sub in studies[1].params.items():
        for nm, t in sub.items():
            if nm.endswith("ln"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    studies[0].params = {g: {k: t.to("cuda") for k, t in sub.items()}
                         for g, sub in studies[1].params.items()}
    out = []
    for st in studies:
        if kind.startswith("attn"):
            kn = StepKnobs("k", remat="full", kv_chunk=int(kind[4:]))
            _, build = st._mixer_kernel("attn", 0, kn, 2)
        elif kind == "dense":
            _, build = st._ffn_kernel("dense", 0, StepKnobs("k"), 2)
        else:
            _, build = st._embed_loss_kernel(StepKnobs("k"), 2)
        fn, args = build()
        out.append(fn(*args))
    from repro_torch.tune.lm_study import _flatten
    for (path, g), (_, c) in zip(_flatten(out[0]), _flatten(out[1])):
        scale = max(1.0, float(c.abs().max()))
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda m: f"{path}: {m}")
