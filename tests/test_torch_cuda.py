"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  No JAX here, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes: the JAX test sweep's (tests/test_kernels.py), plus the serving
path's full-width ones (smollm-135m: d_model 576, 9/3 heads of 64, the
49152-wide tied head read through a transposed view; phi3.5-moe: d_model
4096, 32/8 heads of 128, the router's 16 columns, the experts' 1-10 rows
of 6400, the untied 32064-wide head; deepseek-v2: flash forward and
backward at (dk, dv) = (192, 128) over 128 heads and the reduced (24,
16), with MLA's scale, the absorbed decode's per-head products on strided
views, tied router logits, the study's mla_fb; reduced xlstm-125m and
jamba on the card against the CPU), at its tolerances.
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


# the weight gradient A^T dC in bf16: the train cells' dW shapes (M, K, N)
# (smollm-135m at 16 x 2048 tokens, phi3.5-moe's experts at 1280 rows and
# attention at 8192 tokens), ragged ones (M, N and K no multiple of the
# 128 x 128 tile or the 64-deep K tile; N = 201: B by elements), and A^T
# off alignment ("offset": the pointer; M = 577: the row stride), which
# keep the scalar variant
DW_CASES = [(576, 32768, 576), (576, 32768, 192), (576, 32768, 1536),
            (1536, 32768, 576), (4096, 1280, 6400), (6400, 1280, 4096),
            (4096, 8192, 4096), (584, 4133, 200), (584, 20011, 201),
            (136, 100003, 72), (1000, 777, 1000), (576, 32768, "offset"),
            (577, 4096, 576)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES)
def test_matmul_weight_gradient_a_transposed(cuda_device, case):
    """bf16 A^T dC against the plain version in f32, bit-identical on a
    repeat call (the K splits are summed in a fixed order); the split-K
    counters are back at zero after the call; under a profiler session
    the ``matmul.acol`` and ``matmul.splits`` counters read the plan."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import plan_for
    M, K, N = case
    offset = N == "offset"
    N = 576 if offset else N
    rng = np.random.default_rng(27)
    buf = _dev(rng.standard_normal(K * M + offset, np.float32), torch.bfloat16,
               cuda_device)
    a = buf[int(offset):].view(K, M).T
    b = _dev(rng.standard_normal((K, N), np.float32) / np.sqrt(K),
             torch.bfloat16, cuda_device)
    plan = plan_for(a, b)
    assert plan.path == "tiled"
    assert plan.acol == (not offset and M % 8 == 0)
    assert plan.vec == (plan.acol and N % 8 == 0)
    got, again = ops.matmul(a, b), ops.matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(),
                               ref.matmul_ref(a.float(), b.float()),
                               rtol=1e-2, atol=1e-2)
    if plan.splits > 1:
        _, cnt = _build._scratch[(a.device.index, _build.stream())]
        assert not cnt.any()
    with obs.span("untraced"):      # the session's recorder starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("traced"):    # recorded: the scalar variant counts none
            ops.matmul(a, b)
    assert obs.counters() == ({"other": {"matmul.acol": 1,
                                         "matmul.splits": plan.splits}}
                              if plan.acol else {})


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


# (B, S, H, KVH, dk, dv, MLA's scale?): the three (dk, dv) pairs, S split
# into 4 shards of queries (24 rows: ragged against every tile)
OFFSET_DIMS = [(2, 96, 9, 3, 64, 64, False), (1, 96, 8, 2, 192, 128, True),
               (2, 96, 4, 4, 24, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", OFFSET_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [16, 64])
def test_flash_attention_at_query_offsets_matches_plain(cuda_device, dims,
                                                        dtype, bk):
    """Each shard of a split sequence at its offset r S / 4: the forward
    (with lse) and the backward against the plain versions at the offset,
    dk and dv past the shard's last position exactly 0 (the buffers they
    are written to held NaN first), the shards' dk and dv summed against
    the whole call's, the same bits on a repeat; the autograd path at the
    offset launches both kernels and calls no plain version."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    B, S, H, KVH, dk, dv, mla = dims
    tdt = DTYPES[dtype]
    scale = 1.0 / np.sqrt(dk) if mla else None
    q, k, v = _mla_flash_inputs((B, S, S, H, KVH, dk, dv), tdt, cuda_device,
                                60)
    do = _dev(np.random.default_rng(61).standard_normal(
        (B, S, H, dv), np.float32), tdt, cuda_device)
    o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True, scale=scale)
    whole = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk, scale=scale)
    otol = 4e-2 if dtype == "bfloat16" else 3e-4
    n = S // 4
    sums = [torch.zeros(t.shape, device=cuda_device) for t in whole[1:]]
    for r in range(4):
        off, sl = r * n, slice(r * n, (r + 1) * n)
        qs, dos = q[:, sl], do[:, sl]
        os_, ls = flash_attention_cuda(qs, k, v, bk=bk, with_lse=True,
                                       scale=scale, q_offset=off)
        want_o, want_l = ref.flash_attention_ref(
            qs, k, v, return_lse=True, scale=scale, q_offset=off)
        torch.testing.assert_close(os_.float(), want_o.float(), rtol=otol,
                                   atol=otol)
        torch.testing.assert_close(ls, want_l, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(os_.float(), o[:, sl].float(), rtol=otol,
                                   atol=otol)
        # the caching allocator hands the gradients these NaN blocks back
        junk = [torch.full(t.shape, float("nan"), dtype=tdt,
                           device=cuda_device) for t in (qs, k, v)]
        del junk
        got = flash_attention_bwd_cuda(qs, k, v, os_, ls, dos, bk=bk,
                                       scale=scale, q_offset=off)
        again = flash_attention_bwd_cuda(qs, k, v, os_, ls, dos, bk=bk,
                                         scale=scale, q_offset=off)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = ref.flash_attention_bwd_ref(qs, k, v, os_, ls, dos,
                                           scale=scale, q_offset=off)
        _check_flash_bwd(got, want, dtype)
        for g in got[1:]:
            assert torch.equal(g[:, off + n:], torch.zeros_like(
                g[:, off + n:]))
        for acc, g in zip(sums, got[1:]):
            acc += g.float()
        leaves = [t.clone().requires_grad_() for t in (qs, k, v)]
        n1, p1 = dict(ops.launches), dict(ops.plain_calls)
        out = ops.flash_attention(*leaves, bk=bk, scale=scale, q_offset=off)
        grads = torch.autograd.grad(out, leaves, dos)
        assert ops.launches["flash_attention"] == n1["flash_attention"] + 1
        assert ops.launches["flash_attention_bwd"] == \
            n1["flash_attention_bwd"] + 1
        assert ops.plain_calls == p1
        _check_flash_bwd(grads, want, dtype)
    _check_flash_bwd([s.to(tdt) for s in sums], whole[1:], dtype)


@pytest.mark.cuda
def test_flash_attention_refuses_offsets_past_the_keys(cuda_device):
    """q_offset + Sq > Skv or a negative q_offset under causal raises before
    a launch; without causal the offset is not read."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.zeros(1, 8, 2, 16, device=cuda_device)
    k = torch.zeros(1, 24, 1, 16, device=cuda_device)
    n0 = ops.launches["flash_attention"]
    for off in (17, -1):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention_cuda(q, k, k, q_offset=off)
    assert ops.launches["flash_attention"] == n0
    flash_attention_cuda(q, k, k, causal=False, q_offset=17)
    assert ops.launches["flash_attention"] == n0 + 1


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
    counters = bwd_scratch(1, 2, 512, plan.tile, more.splits, 64, 64)[1]
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
                                 (37, 100, 51), (32768, 576, 1536)])
def test_matmul_backward_on_transposed_views(cuda_device, mkn):
    """dA = dC B^T and dB = A^T dC through the forward kernel on
    transposed views (A^T has unit stride along its rows); f32, and bf16
    at a training microbatch's 32768 tokens (dB's K, split over blocks)."""
    M, K, N = mkn
    dtype = torch.bfloat16 if M == 32768 else torch.float32
    rng = np.random.default_rng(25)
    a = _dev(rng.standard_normal((M, K), np.float32), dtype,
             cuda_device).requires_grad_()
    b = _dev((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
             dtype, cuda_device).requires_grad_()
    # bf16: dC scaled so that dB = A^T dC, a sum over M, stays near 1
    dscale = 1.0 / np.sqrt(M) if dtype == torch.bfloat16 else 1.0
    dc = _dev(rng.standard_normal((M, N), np.float32) * dscale, dtype,
              cuda_device)
    n0 = ops.launches["matmul"]
    da, db = torch.autograd.grad(ops.matmul(a, b), (a, b), dc)
    torch.cuda.synchronize()
    assert ops.launches["matmul"] == n0 + 3
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(da, ref.matmul_ref(dc, b.detach().T), **tol)
    torch.testing.assert_close(db, ref.matmul_ref(a.detach().T, dc), **tol)


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
@pytest.mark.parametrize("kind", ["attn16", "attn64", "dense", "embed",
                                  "mla16", "mla64"])
def test_study_thunk_grads_match_cpu_port(cuda_device, kind):
    """A CUDA ``LMStudy`` kernel's gradients against the port's CPU run on
    the same weights (random norm weights) and inputs: reduced smollm's
    attn_fb, dense_fb and embed_loss_fb, reduced deepseek-v2's mla_fb (the
    flash backward at (24, 16))."""
    from repro_torch.tune.lm_study import LMStudy, StepKnobs
    arch = "deepseek-v2" if kind.startswith("mla") else "smollm-135m"
    studies = [LMStudy(arch, device=d) for d in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(9)
    for grp, sub in studies[1].params.items():
        for nm, t in sub.items():
            if nm.endswith("ln"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    studies[0].params = {g: {k: t.to("cuda") for k, t in sub.items()}
                         for g, sub in studies[1].params.items()}
    out = []
    for st in studies:
        if kind.startswith(("attn", "mla")):
            mixer = kind.rstrip("0123456789")
            kn = StepKnobs("k", remat="full",
                           kv_chunk=int(kind[len(mixer):]))
            _, build = st._mixer_kernel(mixer, 0, kn, 2)
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


DAEMON_KEYS = ["counters", "steady_state_counters", "ratios",
               "second_tuned_serves", "served_while_retuning",
               "drift_detected", "retunes", "events"]


def _no_failure_events(summary_or_events):
    events = summary_or_events if isinstance(summary_or_events, list) \
        else summary_or_events["events"]
    kinds = {e["event"] for e in events}
    assert "study_failed" not in kinds and "scheduler" not in kinds, \
        [e for e in events if e["event"] in ("study_failed", "scheduler")]


@pytest.mark.cuda
def test_daemon_demo_on_the_card_equals_cpu(cuda_device):
    """The reduced daemon demo (synchronous, virtual clocks) on the card
    gives the CPU run's summary, journal included: under virtual clocks
    the protocol does not depend on the device."""
    from repro_torch.serve.tuner import run_daemon_demo
    plain0 = dict(ops.plain_calls)
    card = run_daemon_demo("smollm-135m", device="cuda", synchronous=True)
    assert ops.plain_calls == plain0
    cpu = run_daemon_demo("smollm-135m", device="cpu", synchronous=True)
    _no_failure_events(card)
    for key in DAEMON_KEYS:
        assert card[key] == cpu[key], key


@pytest.mark.cuda
def test_daemon_full_width_shape_miss_lands(cuda_device):
    """A full-width shape miss opens a study on the card that lands a
    winner with no failure hidden in the journal, every kernel launched
    and no plain version called."""
    from repro_torch.api.daemon import TUNED, DaemonConfig
    from repro_torch.serve.tuner import (LMShapeProvider, ServingTuner,
                                         VirtualClock)
    tuner = ServingTuner(
        "smollm-135m", seq_buckets=(16,), clock=VirtualClock(),
        provider=LMShapeProvider(trials=2, max_configs=3, reduced=False,
                                 clock=VirtualClock()),
        config=DaemonConfig(shadow_every=3, serve_min_samples=2,
                            synchronous=True))
    launches0, plain0 = dict(ops.launches), dict(ops.plain_calls)
    assert tuner.serve_step(2, 16)["state"] == "miss"
    assert tuner.daemon.pump() == 1
    info = tuner.serve_step(2, 16)
    torch.cuda.synchronize()
    assert info["state"] == TUNED and info["winner"] is not None
    assert info["cold_banked"] == 0
    assert ops.plain_calls == plain0
    assert all(ops.launches[k] > launches0[k] for k in ops.launches)
    _no_failure_events(tuner.daemon.events)
    tuner.close(checkpoint=False)


# -- the measured mode (linalg/blas.py) ---------------------------------------

# one signature of each compute kind the four ci studies emit
MEASURED_SIGS = [("gemm", (256, 256, 256)), ("gemm", (8, 63, 512)),
                 ("syrk", (256, 256)), ("trmm", (8, 63)),
                 ("trsm", (256, 256)), ("potrf", (256,)), ("trtri", (16,)),
                 ("geqrf", (512, 8)), ("tpqrt", (64, 8)),
                 ("ormqr", (512, 8, 8)), ("tpmqrt", (64, 64, 8)),
                 ("blk2cyc", (2048,))]
MEASURED_MATMUL = {"gemm", "syrk", "trmm", "ormqr", "tpmqrt"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", MEASURED_SIGS)
def test_measured_kind_on_the_card_matches_cpu(cuda_device, name, params):
    """A MeasuredTimer on the card times the kind (the matmul family
    through the matmul kernel: warm-up, timed call and the check's call),
    calls no plain version, and its result on the drawn operands agrees
    with the port's CPU run on the same operands (tests/test_torch_blas.py
    tolerances; geqrf/tpqrt as R^T R, R being unique up to row signs)."""
    from repro_torch.core.signatures import Signature
    from repro_torch.linalg.blas import MeasuredTimer
    sig = Signature("comp", name, params)
    card = MeasuredTimer(seed=0)
    assert card.device.type == "cuda"
    n0, plain0 = ops.launches["matmul"], dict(ops.plain_calls)
    assert card(sig, np.random.default_rng(0)) > 0 and card.calls == 1
    fn, args = card._operands(sig)
    got = args[0].clone() if fn == "copy" else fn(*args)
    torch.cuda.synchronize()
    launched = ops.launches["matmul"] - n0
    assert launched == (3 if name in MEASURED_MATMUL else 0)
    assert ops.plain_calls == plain0
    _, hargs = MeasuredTimer(seed=0, device="cpu")._operands(sig)
    for a, h in zip(args, hargs):
        assert a.dtype == torch.float32 and torch.equal(a.cpu(), h)
    if fn == "copy":
        assert torch.equal(got.cpu(), hargs[0])
        return
    got, want = _np(got), _np(fn(*hargs))
    if name in ("geqrf", "tpqrt"):
        got, want = got.T @ got, want.T @ want
    rtol, arel = (1e-4, 1e-4) if name in MEASURED_MATMUL else (1e-3, 1e-5)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=arel * float(np.abs(want).max()))


# -- the MoE family (models/moe.py; phi3.5-moe) -------------------------------

# the shapes phi3.5-moe's serve and study give the kernels: the router's
# N = 16, the experts' M = cap (1 at a 4-slot decode step, 5 at a 31-token
# prompt, 10 in the study's mb 2 x S 32), and the untied head's N = 32064
MOE_MATMUL = [(4, 4096, 16), (31, 4096, 16), (64, 4096, 16),
              (1, 4096, 6400), (5, 4096, 6400), (10, 4096, 6400),
              (1, 6400, 4096), (5, 6400, 4096), (10, 6400, 4096),
              (4, 4096, 32064), (1, 4096, 32064)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", MOE_MATMUL)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_moe_shapes_match_plain(cuda_device, mkn, dtype):
    M, K, N = mkn
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(31)
    a = _dev(rng.standard_normal((M, K), np.float32), tdt, cuda_device)
    b = _dev(rng.standard_normal((K, N), np.float32) / np.sqrt(K), tdt,
             cuda_device)
    n0 = ops.launches["matmul"]
    got, again = ops.matmul(a, b), ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launches["matmul"] == n0 + 2
    assert torch.equal(got, again)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(ref.matmul_ref(a, b)),
                               rtol=tol, atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(10, 4096, 6400), (10, 6400, 4096),
                                 (1, 4096, 6400), (64, 4096, 16)])
def test_matmul_backward_moe_shapes(cuda_device, mkn):
    """The expert and router products' backward: dW = A^T dC with K = cap
    (or the study's 64 tokens for the router) and dA = dC W^T, on
    transposed views."""
    M, K, N = mkn
    rng = np.random.default_rng(32)
    a = _dev(rng.standard_normal((M, K), np.float32), torch.float32,
             cuda_device).requires_grad_()
    b = _dev((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),
             torch.float32, cuda_device).requires_grad_()
    dc = _dev(rng.standard_normal((M, N), np.float32), torch.float32,
              cuda_device)
    da, db = torch.autograd.grad(ops.matmul(a, b), (a, b), dc)
    torch.cuda.synchronize()
    torch.testing.assert_close(da, ref.matmul_ref(dc, b.detach().T),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, ref.matmul_ref(a.detach().T, dc),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4, 31])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_moe_heads(cuda_device, S, dtype):
    """phi3.5-moe's prefill: d 128, 32 query heads over 8 KV heads."""
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(33)
    q = _dev(rng.standard_normal((1, S, 32, 128), np.float32), tdt,
             cuda_device)
    k, v = (_dev(rng.standard_normal((1, S, 8, 128), np.float32), tdt,
                 cuda_device) for _ in range(2))
    got, again = (ops.flash_attention(q, k, v, causal=True),
                  ops.flash_attention(q, k, v, causal=True))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(q, k, v, causal=True)),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 31])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_moe_width(cuda_device, rows, dtype):
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(34)
    x = _dev(rng.standard_normal((rows, 4096), np.float32), tdt, cuda_device)
    w = _dev((rng.standard_normal(4096) * 0.1).astype(np.float32), tdt,
             cuda_device)
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(ref.rmsnorm_ref(x, w)),
                               rtol=tol, atol=tol)


def _moe_layer(n_shared, device):
    """Reduced phi3.5-moe's layer-0 FFN weights (seeded) on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("phi3.5-moe", reduced=True)
    cfg = replace(cfg, moe=replace(cfg.moe, n_shared=n_shared))
    p = init_params(cfg, torch.Generator().manual_seed(35), "cpu")
    return cfg, {k[4:]: v[0].to(device) for k, v in p["pos0"].items()
                 if k.startswith("ffn_")}


@pytest.mark.cuda
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_ffn_on_the_card_matches_cpu(cuda_device, dispatch, n_shared):
    """The MoE FFN on the card: the CPU run's routing (experts and kept
    pairs), its output within the model tolerance, the same bits on a
    repeat, 1 + 3E (+ 3 shared) matmul launches and no plain call."""
    from repro_torch.models import moe
    cfg, pc = _moe_layer(n_shared, "cpu")
    pg = {k: v.to(cuda_device) for k, v in pc.items()}
    x = torch.from_numpy(np.random.default_rng(36).standard_normal(
        (2, 13, 64)).astype(np.float32))
    rc, rg = [], []
    want = moe.moe_ffn(pc, x, cfg, dispatch=dispatch, routing=rc)
    n0, plain0 = ops.launches["matmul"], dict(ops.plain_calls)
    got = moe.moe_ffn(pg, x.to(cuda_device), cfg, dispatch=dispatch,
                      routing=rg)
    again = moe.moe_ffn(pg, x.to(cuda_device), cfg, dispatch=dispatch)
    torch.cuda.synchronize()
    per_call = 1 + 3 * cfg.moe.n_experts + 3 * n_shared
    assert ops.launches["matmul"] == n0 + 2 * per_call
    assert ops.plain_calls == plain0
    assert torch.equal(got, again)
    for (gi, gk), (ci, ck) in zip(rg, rc):
        assert torch.equal(gi.cpu(), ci) and torch.equal(gk.cpu(), ck)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_moe_fb_grads_match_cpu_port(cuda_device, dispatch):
    """The study's ``moe_fb`` gradients on the card against the port's CPU
    run on the same weights and inputs (reduced phi3.5-moe)."""
    from repro_torch.tune.lm_study import LMStudy, StepKnobs, _flatten
    studies = [LMStudy("phi3.5-moe", device=d) for d in ("cuda", "cpu")]
    studies[0].params = {g: {k: t.to("cuda") for k, t in sub.items()}
                         for g, sub in studies[1].params.items()}
    out = []
    for st in studies:
        _, build = st._ffn_kernel(
            "moe", 0, StepKnobs("k", moe_dispatch=dispatch), 2)
        fn, args = build()
        out.append(fn(*args))
    for (path, g), (_, c) in zip(_flatten(out[0]), _flatten(out[1])):
        scale = max(1.0, float(c.abs().max()))
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda m: f"{path}: {m}")


# -- MLA (deepseek-v2): flash at (dk, dv), the absorbed products, ties --------

MLA_FLASH = [(1, 4, 4, 128, 128, 192, 128),      # full width, S 4 and 31
             (1, 31, 31, 128, 128, 192, 128),
             (2, 33, 70, 8, 2, 192, 128),        # GQA, suffix, ragged tiles
             (1, 16, 16, 4, 4, 24, 16),          # reduced, served with --reduced
             (2, 37, 37, 4, 2, 24, 16)]


def _mla_flash_inputs(dims, tdt, device, seed):
    B, Sq, Skv, H, KVH, dk, dv = dims
    rng = np.random.default_rng(seed)
    return (_dev(rng.standard_normal(shape, np.float32), tdt, device)
            for shape in ((B, Sq, H, dk), (B, Skv, KVH, dk),
                          (B, Skv, KVH, dv)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", MLA_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [None, 16, 64])
def test_flash_attention_mla_pairs_match_plain(cuda_device, dims, dtype, bk):
    """The forward at MLA's (dk, dv) pairs with a scale other than
    1/sqrt(dk) (the padding of dk 24 to 32 in bf16 must not move it), at
    every KV tile the plan gives the pair (f32 (192, 128) takes 32 for a
    64-key chunk), the same bits on a repeat."""
    tdt = DTYPES[dtype]
    q, k, v = _mla_flash_inputs(dims, tdt, cuda_device, 40)
    scale = 0.7 / np.sqrt(dims[5])
    n0 = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, bk=bk, scale=scale)
    again = ops.flash_attention(q, k, v, causal=True, bk=bk, scale=scale)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + 2
    assert got.shape == q.shape[:3] + (dims[6],)
    assert torch.equal(got, again)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_mla_strided_and_misaligned(cuda_device, dtype):
    """(192, 128) from strided views: q a slice of a wider tensor (heads
    200 apart), k one element off 16 bytes (no cp.async), v a head slice:
    the plan turns cp.async off and the result is the plain version's."""
    from repro_torch.kernels.flash_attention import plan_flash
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(41)
    B, S, H = 1, 31, 16
    q = _dev(rng.standard_normal((B, S, H, 200), np.float32), tdt,
             cuda_device)[..., :192]
    buf = _dev(rng.standard_normal(1 + B * S * H * 192, np.float32), tdt,
               cuda_device)
    k = buf[1:].view(B, S, H, 192)
    v = _dev(rng.standard_normal((B, S, 2 * H, 128), np.float32), tdt,
             cuda_device)[:, :, ::2]
    assert not plan_flash(q, k, v).vec
    assert plan_flash(q.contiguous(), k.clone(), v.contiguous()).vec
    scale = 1.0 / np.sqrt(192)
    got = ops.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(q, k, v, scale=scale)),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_uninstantiated_pair_raises(cuda_device):
    """A pair the kernel is not instantiated at raises before a launch,
    naming the pairs; a tile the plan would never give (f32 (192, 128)
    at 64 keys) is refused by the C entry."""
    import math
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (_ARGTYPES, plan_flash)
    q = torch.zeros(1, 8, 2, 192, device=cuda_device)
    n0 = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :96], q[..., :96], q[..., :64])
    assert ops.launches["flash_attention"] == n0
    k, v = q.clone(), torch.zeros(1, 8, 2, 128, device=cuda_device)
    o = torch.empty(1, 8, 2, 128, device=cuda_device)
    plan = plan_flash(q, k, v)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    launch = _build.entry("flash_attention", _ARGTYPES)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None, 1, 2, 2, 8, 8, 192, 128, 0, *strides,
                 1.0 / math.sqrt(192), 1, plan.gh, plan.bq, 64, 1, 0,
                 _build.stream())
    assert err != 0
    assert ops.launches["flash_attention"] == n0


# the backward at MLA's pairs: (B, Sq, Skv, H, KVH, dk, dv) -- the study's
# full width (mb 2 x S 32, 128/128 heads), GQA with a suffix and ragged
# tiles, and the reduced pair at the reduced study's shape and a ragged one
MLA_BWD = [(2, 32, 32, 128, 128, 192, 128), (2, 33, 70, 8, 2, 192, 128),
           (2, 32, 32, 4, 4, 24, 16), (2, 37, 37, 4, 2, 24, 16)]


def _mla_bwd_inputs(dims, tdt, device, seed):
    B, Sq, _, H, _, _, dv = dims
    q, k, v = _mla_flash_inputs(dims, tdt, device, seed)
    do = _dev(np.random.default_rng(seed + 1).standard_normal(
        (B, Sq, H, dv), np.float32), tdt, device)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dims", MLA_BWD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [16, 32, 64])
def test_flash_attention_bwd_mla_pairs_match_plain(cuda_device, dims, dtype,
                                                   bk):
    """The backward at MLA's (dk, dv) pairs with MLA's scale, at every tile
    the plan gives the pair (f32 (192, 128): a 64-key chunk takes 32),
    against the plain backward: dq and dk dk wide, dv dv wide, the same
    bits on a repeat; the autograd path launches both kernels and calls no
    plain version."""
    from repro_torch.kernels.flash_attention import (
        bwd_tiles, flash_attention_bwd_cuda, flash_attention_cuda,
        kv_tile, plan_flash_bwd)
    tdt = DTYPES[dtype]
    dk, dv = dims[5:]
    q, k, v, do = _mla_bwd_inputs(dims, tdt, cuda_device, 50)
    scale = 1.0 / np.sqrt(dk)
    o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True, scale=scale)
    plan = plan_flash_bwd(q, k, v, o, do, bk)
    assert plan.tile == kv_tile(bk, dims[2], tdt, bwd_tiles(tdt, dk, dv))
    n0 = ops.launches["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk, scale=scale)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk, scale=scale)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == n0 + 2
    assert [tuple(g.shape) for g in got] == [tuple(t.shape)
                                             for t in (q, k, v)]
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale)
    _check_flash_bwd(got, want, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, p1 = dict(ops.launches), dict(ops.plain_calls)
    out = ops.flash_attention(*leaves, bk=bk, scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    assert ops.launches["flash_attention"] == n1["flash_attention"] + 1
    assert ops.launches["flash_attention_bwd"] == \
        n1["flash_attention_bwd"] + 1
    assert ops.plain_calls == p1
    _check_flash_bwd(grads, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(192, 128), (24, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_mla_splits_key_tiles(cuda_device, pair, dtype):
    """A long prompt at MLA's pairs: several dK/dV blocks a key tile, their
    partials tile (dk + dv) floats each in the workspace, summed in split
    order; the same bits twice, the counters back at zero."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        bwd_scratch, flash_attention_bwd_cuda, flash_attention_cuda,
        plan_flash_bwd)
    tdt = DTYPES[dtype]
    dims = (1, 512, 512, 4, 2) + pair
    q, k, v, do = _mla_bwd_inputs(dims, tdt, cuda_device, 51)
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
    counters = bwd_scratch(1, 2, 512, plan.tile, plan.splits, *pair)[1]
    _, cnt = _build.scratch(q.device, _build.stream(), 0, counters)
    assert int(cnt[:counters].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(192, 128), (24, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_mla_strided_and_misaligned(cuda_device, pair,
                                                        dtype):
    """MLA's pairs from strided views: q a slice of wider rows, k one
    element off 16 bytes, v a head slice, dO a slice of wider rows: the
    element loads, against the plain version; the same views made
    contiguous take cp.async and agree too."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_flash_bwd)
    tdt = DTYPES[dtype]
    dk, dv = pair
    rng = np.random.default_rng(52)
    B, S, H = 1, 31, 16
    mk = lambda *s: _dev(rng.standard_normal(s, np.float32),  # noqa: E731
                         tdt, cuda_device)
    q = mk(B, S, H, dk + 8)[..., :dk]
    k = mk(1 + B * S * H * dk)[1:].view(B, S, H, dk)
    v = mk(B, S, 2 * H, dv)[:, :, ::2]
    do = mk(B, S, H, dv + 8)[..., :dv]
    scale = 1.0 / np.sqrt(dk)
    for bk in (16, 64):
        o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True,
                                      scale=scale)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale)
        assert not plan_flash_bwd(q, k, v, o, do, bk).vec
        _check_flash_bwd(flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk,
                                                  scale=scale), want, dtype)
        qc, kc, vc, dc = (t.contiguous() for t in (q, k.clone(), v, do))
        assert plan_flash_bwd(qc, kc, vc, o, dc, bk).vec
        _check_flash_bwd(flash_attention_bwd_cuda(qc, kc, vc, o, lse, dc,
                                                  bk=bk, scale=scale),
                         want, dtype)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_the_tile_it_leaves_out(cuda_device):
    """f32 at (192, 128) with 64 keys is not instantiated (its tiles exceed
    a block's shared memory): the plan takes 32 for a 64-key chunk, and a
    plan of the kernel's own geometry at 64 keys is refused by the C entry
    before any launch."""
    from dataclasses import replace as dc_replace
    from repro_torch.kernels.flash_attention import (
        BWD_TILES_OUT, _plan_flash_bwd, flash_attention_bwd_cuda,
        flash_attention_cuda, plan_flash_bwd)
    assert (torch.float32, 192, 128, 64) in BWD_TILES_OUT
    q, k, v, do = _mla_bwd_inputs((1, 70, 70, 4, 2, 192, 128),
                                  torch.float32, cuda_device, 53)
    o, lse = flash_attention_cuda(q, k, v, bk=64, with_lse=True)
    plan = plan_flash_bwd(q, k, v, o, do, 64)
    assert plan.tile == 32
    at64 = _plan_flash_bwd(torch.float32, 1, 70, 70, 4, 2, 192, 128,
                           plan.vec, 64, True)
    assert (at64.tile, at64.warps, at64.rows) == (64, 8, 32)
    n0 = ops.launches["flash_attention_bwd"]
    for bad in (at64, dc_replace(plan, tile=64)):
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_attention_bwd_cuda(q, k, v, o, lse, do, plan=bad)
    assert ops.launches["flash_attention_bwd"] == n0
    _check_flash_bwd(flash_attention_bwd_cuda(q, k, v, o, lse, do, plan=plan),
                     ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                     "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(4, 128, 512, 128), (4, 512, 128, 128),
                                  (1, 16, 32, 4), (2, 32, 16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_absorbed_per_head_views(cuda_device, dims, dtype):
    """The absorbed decode's products, head by head on strided views of
    the 2-D weights: q_nope[:, h] (rows H (dn + dr) apart) times wk_b's
    head block transposed (K-contiguous, columns H dn apart), and o_lat[:,
    h] times wv_b's head block (rows H dv apart); full width (4 x 128 x
    512, 4 x 512 x 128 over 128 heads) and reduced."""
    B, K, N, H = dims
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(42)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    if K < N:       # q_lat = q_nope . wk_b[h]^T: K = d_nope, N = kv_lora
        a_all = _dev(rng.standard_normal((B, H, K + K // 2), np.float32),
                     tdt, cuda_device)
        w = _dev((rng.standard_normal((N, H * K)) / np.sqrt(N))
                 .astype(np.float32), tdt, cuda_device)
        pairs = [(a_all[:, h, :K], w[:, h * K:(h + 1) * K].T)
                 for h in range(H)]
    else:           # o = o_lat . wv_b[h]: K = kv_lora, N = d_v
        a_all = _dev(rng.standard_normal((B, H, K), np.float32), tdt,
                     cuda_device)
        w = _dev((rng.standard_normal((K, H * N)) / np.sqrt(K))
                 .astype(np.float32), tdt, cuda_device)
        pairs = [(a_all[:, h], w[:, h * N:(h + 1) * N]) for h in range(H)]
    n0 = ops.launches["matmul"]
    got = [ops.matmul(a, b) for a, b in pairs]
    torch.cuda.synchronize()
    assert ops.launches["matmul"] == n0 + H
    for g, (a, b) in zip(got, pairs):
        np.testing.assert_allclose(_np(g), _np(ref.matmul_ref(a, b)),
                                   rtol=tol, atol=tol * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts,k", [(4, 2), (16, 2), (160, 6)])
def test_router_topk_ties_on_the_card_equal_cpu(cuda_device, n_experts, k):
    """Tied router logits (all zero, and half the experts tied on top) pick
    the same experts and gates on the card as on the CPU: the lower index
    first, as lax.top_k."""
    from repro_torch.models import moe
    logits = torch.zeros(6, n_experts)
    logits[3, n_experts // 2:] = 1.0
    logits[4, ::3] = -1.0
    logits[5] = torch.randn(n_experts, generator=torch.Generator()
                            .manual_seed(0))
    cg, ci = moe.router_topk(logits, k)
    gg, gi = moe.router_topk(logits.to(cuda_device), k)
    assert torch.equal(ci[0], torch.arange(k))
    assert torch.equal(gi.cpu(), ci)
    torch.testing.assert_close(gg.cpu(), cg, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_mla_model_on_the_card_matches_cpu(cuda_device):
    """Reduced deepseek-v2 on the card against the port's CPU run: prefill
    and 3 teacher-forced absorbed decode steps, logits within the serving
    tolerance, and every launch a kernel's (no plain call)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_params
    cfg = get_config("deepseek-v2", reduced=True)
    pc = init_params(cfg, torch.Generator().manual_seed(43), "cpu")
    gen = torch.Generator().manual_seed(44)
    for nm in ("mix_ln", "mix_q_ln", "mix_kv_ln"):
        pc["pos0"][nm] = torch.randn(pc["pos0"][nm].shape, generator=gen) \
            * 0.1
    pg = {g: {k: v.to(cuda_device) for k, v in sub.items()}
          for g, sub in pc.items()}
    toks = torch.from_numpy(np.random.default_rng(45).integers(
        0, cfg.vocab, (2, 14)))
    outs = []
    for dev, params in (("cuda", pg), ("cpu", pc)):
        model = Model(cfg, device=dev)
        tt = toks.to(dev)
        plain0 = dict(ops.plain_calls)
        lg, cache, _ = model.prefill(params, {"tokens": tt[:, :11]}, 32)
        seq = [lg.cpu()]
        for t in range(11, 14):
            lg, cache = model.decode_step(params, cache, t,
                                          {"tokens": tt[:, t:t + 1]})
            seq.append(lg.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.plain_calls == plain0
        outs.append(torch.stack(seq))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_ssm_model_on_the_card_matches_cpu(cuda_device, arch):
    """Reduced xlstm-125m and jamba on the card against the port's CPU run:
    prefill and 3 teacher-forced decode steps, logits within the serving
    tolerance; every kernel of the model's path launched (matmul and
    RMSNorm; flash attention for jamba's attention position) and no plain
    call.  The norms are drawn, and jamba's MoE down-projections scaled by
    0.1 (its MoE reads the un-normalized residual, whose scale each MoE
    layer roughly squares; ``tests/test_torch_ssm.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_params
    cfg = get_config(arch, reduced=True)
    pc = init_params(cfg, torch.Generator().manual_seed(46), "cpu")
    gen = torch.Generator().manual_seed(47)
    for sub in pc.values():
        for nm in list(sub):
            if nm.endswith("ln"):
                sub[nm] = torch.randn(sub[nm].shape, generator=gen) * 0.1
            elif nm == "ffn_w_down" and "ffn_router" in sub:
                sub[nm] = sub[nm] * 0.1
    pg = {g: {k: v.to(cuda_device) for k, v in sub.items()}
          for g, sub in pc.items()}
    toks = torch.from_numpy(np.random.default_rng(48).integers(
        0, cfg.vocab, (2, 14)))
    on_path = ("matmul", "rmsnorm") + (
        ("flash_attention",) if "attn" in cfg.pattern else ())
    outs = []
    for dev, params in (("cuda", pg), ("cpu", pc)):
        model = Model(cfg, device=dev)
        tt = toks.to(dev)
        plain0, n0 = dict(ops.plain_calls), dict(ops.launches)
        lg, cache, _ = model.prefill(params, {"tokens": tt[:, :11]}, 32)
        seq = [lg.cpu()]
        for t in range(11, 14):
            lg, cache = model.decode_step(params, cache, t,
                                          {"tokens": tt[:, t:t + 1]})
            seq.append(lg.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.plain_calls == plain0
            assert all(ops.launches[k] > n0[k] for k in on_path)
        outs.append(torch.stack(seq))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-2b"])
def test_frontend_model_on_the_card_matches_cpu(cuda_device, arch):
    """Reduced musicgen-large (4 codebooks: (B, S, 4) tokens, (B, 4, V)
    logits, a head launch a codebook) and internvl2-2b (a prefill of 8
    patches in front of the prompt, decode at P + t) on the card against
    the port's CPU run: prefill and 3 teacher-forced decode steps, logits
    within the serving tolerance; matmul, RMSNorm and flash attention
    launched, no plain call."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_params
    cfg = get_config(arch, reduced=True)
    pc = init_params(cfg, torch.Generator().manual_seed(49), "cpu")
    gen = torch.Generator().manual_seed(50)
    for sub in pc.values():
        for nm in list(sub):
            if nm.endswith("ln"):
                sub[nm] = torch.randn(sub[nm].shape, generator=gen) * 0.1
    pg = {g: {k: v.to(cuda_device) for k, v in sub.items()}
          for g, sub in pc.items()}
    rng = np.random.default_rng(51)
    trail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 14) + trail))
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.1)
    P = cfg.n_patches
    outs = []
    for dev, params in (("cuda", pg), ("cpu", pc)):
        model = Model(cfg, device=dev)
        tt = toks.to(dev)
        batch = {"tokens": tt[:, :11]}
        if P:
            batch["patches"] = patches.to(dev)
        plain0, n0 = dict(ops.plain_calls), dict(ops.launches)
        lg, cache, t0 = model.prefill(params, batch, 64)
        assert t0 == P + 11
        seq = [lg.cpu()]
        for t in range(11, 14):
            lg, cache = model.decode_step(params, cache, P + t,
                                          {"tokens": tt[:, t:t + 1]})
            seq.append(lg.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.plain_calls == plain0
            assert all(ops.launches[k] > n0[k]
                       for k in ("matmul", "rmsnorm", "flash_attention"))
        outs.append(torch.stack(seq))
    assert outs[0].shape == ((4, 2, 4, 256) if trail else (4, 2, 256))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-4)


TRAIN_FAMILIES = ["smollm-135m", "phi3.5-moe", "deepseek-v2", "xlstm-125m",
                  "jamba-v0.1-52b", "musicgen-large", "internvl2-2b"]


def _train_inputs(arch, seed):
    """Reduced ``arch``'s seeded weights on the CPU, the norms drawn and
    MoE down-projections scaled by 0.1 (as above), and the training
    launcher's first batch of 2 x 16 tokens (a patch prefix in front)."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.data import synthetic_batch
    cfg = get_config(arch, reduced=True)
    pc = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for sub in pc.values():
        for nm in list(sub):
            if nm.endswith("ln"):
                sub[nm] = torch.randn(sub[nm].shape, generator=gen) * 0.1
            elif nm == "ffn_w_down" and "ffn_router" in sub:
                sub[nm] = sub[nm] * 0.1
    batch = synthetic_batch(cfg, Shape("t", 16 + cfg.n_patches, 2, "train"),
                            0)
    return cfg, pc, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_loss_and_grads_on_the_card_match_cpu(cuda_device, arch,
                                                    remat):
    """One reduced microbatch's ``Model.loss`` and its gradients on the
    card against the port's CPU run: the loss within rtol 1e-4, every
    gradient within atol 1e-5 x its largest magnitude (rtol 1e-4); the
    backward kernels launched (flash attention's where the family has
    attention), no plain call."""
    from repro_torch.models.model import Model, ModelKnobs
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tune.lm_study import _flatten
    cfg, pc, batch = _train_inputs(arch, 52)
    knobs = ModelKnobs(kv_chunk=16, ssm_chunk=8, moe_dispatch="sort",
                       remat=remat)
    out = {}
    for dev in ("cuda", "cpu"):
        params = {g: {k: v.to(dev) for k, v in sub.items()}
                  for g, sub in pc.items()}
        plain0, n0 = dict(ops.plain_calls), dict(ops.launches)
        out[dev] = loss_and_grads(Model(cfg, knobs, device=dev), params,
                                  {k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.plain_calls == plain0
            attention = bool({"attn", "mla"} & set(cfg.pattern))
            for k in ("matmul", "rmsnorm", "rmsnorm_bwd") + (
                    ("flash_attention", "flash_attention_bwd")
                    if attention else ()):
                assert ops.launches[k] > n0[k], k
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(gc)):
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg="/".join(path))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe"])
def test_train_runs_on_the_card_are_bitwise_equal(cuda_device, arch):
    """Two straight runs of the training launcher on the card (reduced, 3
    steps of 4 x 16 in 2 microbatches) end on the same losses, parameters
    and AdamW state, bit for bit (the MoE's sort dispatch and its index
    writes included)."""
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import _flatten
    runs = [train_cli.main(["--arch", arch, "--reduced", "--steps", "3",
                            "--batch", "4", "--seq", "16", "--grad-accum",
                            "2", "--log-every", "1"]) for _ in range(2)]
    assert [h["loss"] for h in runs[0]["history"]] == \
        [h["loss"] for h in runs[1]["history"]]
    for key in ("params", "opt"):
        for (p, a), (_, b) in zip(_flatten(runs[0][key]),
                                  _flatten(runs[1][key])):
            assert a.device.type == "cuda" and torch.equal(a, b), p


@pytest.fixture
def world1_mesh(cuda_device):
    """A (1, 1) (data, model) mesh of a world-1 NCCL group, destroyed
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def _counted(fn):
    """(fn(), the launches it made, the plain calls it made)."""
    l0, p0 = dict(ops.launches), dict(ops.plain_calls)
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: ops.launches[k] - l0[k] for k in l0},
            {k: ops.plain_calls[k] - p0[k] for k in p0})


@pytest.mark.cuda
def test_sharded_step_on_a_world1_nccl_mesh_is_the_unsharded_step(
        world1_mesh):
    """The sharded train step under cp on a (1, 1) NCCL mesh (reduced
    smollm-135m, ga 2, 4 x 32) gives the unsharded step's loss,
    parameters and AdamW state bit for bit, with the same launches and no
    plain call."""
    from repro_torch.models.model import Model, ModelKnobs
    from repro_torch.parallel.sharding import gather, make_rules, place
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        opt_shardings, placed_train_step,
                                        shard_params)
    cfg, pc, _ = _train_inputs("smollm-135m", 61)
    model = Model(cfg, ModelKnobs(kv_chunk=16), device="cuda")
    params = {g: {k: v.cuda() for k, v in sub.items()}
              for g, sub in pc.items()}
    gen = torch.Generator().manual_seed(62)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen)
             for k in ("tokens", "labels")}
    tc = TrainConfig(grad_accum=2, optimizer=AdamWConfig(lr=1e-3, warmup=1))
    (p1, o1, m1), l1, pl1 = _counted(lambda: make_train_step(model, tc)(
        params, adamw_init(params), {k: v.cuda() for k, v in batch.items()}))
    rules = make_rules("cp").with_mesh(world1_mesh)
    step = placed_train_step(model, rules, tc)
    (p2, o2, m2), l2, pl2 = _counted(lambda: step(
        shard_params(model, params, rules),
        place(adamw_init(params), opt_shardings(model, rules)), batch))
    assert l2 == l1 and l1["matmul"] > 0 and not any(pl1.values()) \
        and not any(pl2.values())
    assert float(m2["loss"]) == float(m1["loss"])
    for (p, a), (_, b) in zip(_flatten({"p": gather(p2), "o": gather(o2)}),
                              _flatten({"p": p1, "o": o1})):
        assert a.is_cuda and torch.equal(a, b), p


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matmul", "linear", "rmsnorm", "flash"])
def test_op_rule_on_the_card_is_the_kernel(world1_mesh, op):
    """Each op's placement rule on the card (a (1, 1) NCCL mesh, every
    input sharded where the rule keeps it): the kernel's own output and
    gradients bit for bit, the same launches, no plain call."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers
    S0, S1, S2, R = Shard(0), Shard(1), Shard(2), Replicate()
    fn, shapes, places = {
        "matmul": (ops.matmul, [(64, 576), (576, 1536)], [(S0, R), (R, S1)]),
        "linear": (layers.linear, [(2, 32, 576), (576, 1536)],
                   [(S0, S1), (S0, R)]),
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w, eps=1e-5),
                    [(2, 32, 576), (576,)], [(S0, S1), (R, R)]),
        "flash": (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                  [(2, 32, 9, 64), (2, 32, 3, 64), (2, 32, 3, 64)],
                  [(S0, S2), (S0, S2), (S0, S2)]),
    }[op]
    gen = torch.Generator().manual_seed(63)
    whole = [torch.randn(s, generator=gen).cuda() for s in shapes]
    g_out = None

    def run(inputs):
        nonlocal g_out
        out = fn(*inputs)
        full = out.full_tensor() if hasattr(out, "full_tensor") else out
        if g_out is None:
            g_out = torch.randn(full.shape, generator=gen).cuda()
        (full * g_out).sum().backward()
        return [full.detach()] + [
            t.grad.full_tensor() if hasattr(t.grad, "full_tensor")
            else t.grad for t in inputs]

    want, l1, p1 = _counted(lambda: run(
        [t.clone().requires_grad_(True) for t in whole]))
    got, l2, p2 = _counted(lambda: run(
        [distribute_tensor(t, world1_mesh, p, src_data_rank=None)
         .requires_grad_(True) for t, p in zip(whole, places)]))
    assert l2 == l1 and not any(p1.values()) and not any(p2.values())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("places", ["batch/seq", "batch/heads"])
def test_cache_writes_on_a_world1_nccl_mesh_are_rank_local(world1_mesh,
                                                           places):
    """The cache's write rules on the card: ``cache_update`` (one position
    a row) and ``write_block`` (a prefill's block into a slot) on a cache
    placed on a (1, 1) NCCL mesh write the same bits as on the plain
    tensor, in the DTensor's own storage, with no kernel launch and no
    plain call."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import write_block
    pl = {"batch/seq": (Shard(0), Shard(1)),
          "batch/heads": (Shard(0), Shard(2))}[places]
    gen = torch.Generator().manual_seed(71)
    cache = torch.randn((4, 256, 3, 64), generator=gen).cuda()
    new = torch.randn((4, 1, 3, 64), generator=gen).cuda()
    t = torch.tensor([0, 17, 255, 128]).cuda()
    block = torch.randn((1, 31, 3, 64), generator=gen).cuda()
    want = cache.clone()
    layers.cache_update(want, new, t)
    write_block(want, block, (2, 0, 0, 0))
    dc = distribute_tensor(cache.clone(), world1_mesh, pl,
                           src_data_rank=None)
    storage = dc.to_local().data_ptr()
    (_, l1, p1) = _counted(lambda: (
        layers.cache_update(dc, distribute_tensor(new, world1_mesh, (
            Shard(0), Shard(2))), t),
        write_block(dc, block, (2, 0, 0, 0))))
    assert dc.to_local().data_ptr() == storage
    assert torch.equal(dc.full_tensor(), want)
    assert not any(l1.values()) and not any(p1.values())


@pytest.fixture
def world1_3d_mesh(cuda_device):
    """``jaxdist.make_3d_mesh(1)`` over a world-1 NCCL group, destroyed
    after the test."""
    import torch.distributed as dist
    from repro_torch.jaxdist import make_3d_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_3d_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_jaxdist_on_a_world1_mesh(world1_3d_mesh):
    """``matmul_3d`` on a (1, 1, 1) NCCL mesh is one matmul launch, bit for
    bit the kernel on the whole operands; ``tsqr`` and ``cholesky_3d``
    (n 256, block 64) reproduce their inputs against ``torch.linalg`` on
    the card, with no plain call."""
    from repro_torch.jaxdist import cholesky_3d, matmul_3d, tsqr
    mesh = world1_3d_mesh
    gen = torch.Generator().manual_seed(72)
    a = torch.randn((512, 384), generator=gen).cuda()
    b = torch.randn((384, 256), generator=gen).cuda()
    c, l1, p1 = _counted(lambda: matmul_3d(a, b, mesh).full_tensor())
    assert l1["matmul"] == 1 and not any(p1.values())
    assert torch.equal(c, ops.matmul(a, b))
    m = torch.randn((4096, 64), generator=gen).cuda()
    (q, r), _, p2 = _counted(lambda: tsqr(m, mesh, "x"))
    q, r = q.full_tensor(), r.full_tensor()
    torch.testing.assert_close(q @ r, m, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(q.T @ q, torch.eye(64, device="cuda"),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(r.abs(), torch.linalg.qr(m)[1].abs(),
                               rtol=1e-4, atol=1e-4)
    n = 256
    x = torch.randn((n, n), generator=gen).cuda()
    spd = x @ x.T + n * torch.eye(n, device="cuda")
    (l, linv), l3, p3 = _counted(lambda: cholesky_3d(spd, mesh, block=64))
    l, linv = l.full_tensor(), linv.full_tensor()
    torch.testing.assert_close(l, torch.linalg.cholesky(spd), rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(l @ linv, torch.eye(n, device="cuda"),
                               rtol=2e-3, atol=2e-3)
    assert l3["matmul"] > 0 and not any(p2.values()) \
        and not any(p3.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_ssm_sharded_step_on_a_world1_nccl_mesh_is_the_unsharded_step(
        world1_mesh, arch):
    """Reduced xlstm-125m and jamba, one sharded step under cp on a (1, 1)
    NCCL mesh (the scans in their manual regions): the unsharded step's
    loss, parameters and moments bit for bit, the same launches, no plain
    call."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, ModelKnobs
    from repro_torch.parallel.sharding import gather, make_rules, place
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        opt_shardings, placed_train_step,
                                        shard_params)
    from repro_torch.tune.lm_study import _flatten
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, ModelKnobs(ssm_chunk=8, kv_chunk=16), device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen)
             for k in ("tokens", "labels")}
    tc = TrainConfig(grad_accum=2, optimizer=AdamWConfig(lr=1e-3, warmup=1))
    (p1, o1, m1), l1, pl1 = _counted(lambda: make_train_step(model, tc)(
        params, adamw_init(params), {k: v.cuda() for k, v in batch.items()}))
    rules = make_rules("cp").with_mesh(world1_mesh)
    step = placed_train_step(model, rules, tc)
    (p2, o2, m2), l2, pl2 = _counted(lambda: step(
        shard_params(model, params, rules),
        place(adamw_init(params), opt_shardings(model, rules)), batch))
    assert l2 == l1 and l1["matmul"] > 0 and not any(pl1.values()) \
        and not any(pl2.values())
    assert float(m2["loss"]) == float(m1["loss"])
    for (p, a), (_, b) in zip(_flatten({"p": gather(p2), "o": gather(o2)}),
                              _flatten({"p": p1, "o": o1})):
        assert a.is_cuda and torch.equal(a, b), p


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m",
                                  "deepseek-v2"])
def test_engine_under_rules_on_a_world1_nccl_mesh(world1_mesh, arch):
    """The engine under cp on a (1, 1) NCCL mesh (reduced configurations;
    deepseek-v2's MoE at capacity factor E / top_k, where neither the
    per-shard capacity nor the one-device sort drops a pair): the
    one-device engine's tokens, the same launches, no plain call."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, ModelKnobs
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = get_config(arch, reduced=True)
    if cfg.moe:
        cfg = replace(cfg, moe=replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = Model(cfg, ModelKnobs(ssm_chunk=8, kv_chunk=16), device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 8, 16, 7, 3)]

    def serve(rules):
        eng = Engine(model, params, ServeConfig(batch_size=4, s_max=64,
                                                max_new_tokens=6),
                     rules=rules)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p))
        return {u: r.tokens for u, r in eng.run().items()}
    want, l1, p1 = _counted(lambda: serve(None))
    got, l2, p2 = _counted(lambda: serve(
        make_rules("cp").with_mesh(world1_mesh)))
    assert got == want and l2 == l1
    assert not any(p1.values()) and not any(p2.values())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matmul", "rmsnorm", "flash_attention"])
def test_cuda_tensors_never_take_the_fake_branch(cuda_device, op):
    """The dry-run's branch of ``ops`` is for fake tensors only: on CUDA
    tensors each op launches its kernel, forward and backward, and
    charges nothing to an active collector."""
    from repro_torch.kernels.cost import charging
    g = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=g) \
            .requires_grad_(True)
    args = {"matmul": (rnd(64, 96), rnd(96, 32)),
            "rmsnorm": (rnd(8, 128), rnd(128)),
            "flash_attention": (rnd(2, 64, 4, 32), rnd(2, 64, 2, 32),
                                rnd(2, 64, 2, 32))}[op]
    fn = getattr(ops, op)
    l0 = dict(ops.launches)
    with charging() as c:
        out = fn(*args)
        torch.autograd.grad(out.sum(), args)
    torch.cuda.synchronize()
    assert c.calls == {}
    launched = {k: ops.launches[k] - l0[k] for k in l0}
    assert launched[op] >= 1
    assert launched.get(op + "_bwd", launched["matmul"]) >= 1


@pytest.fixture
def world1_pod_mesh(cuda_device):
    """A (1, 1, 1) (pod, data, model) mesh of a world-1 NCCL group,
    destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(1, pod=1, device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_pipeline_pod1_on_the_card_equals_model_loss(world1_pod_mesh):
    """``pipeline_loss`` at pod 1 on the card: reduced smollm-135m, 8 x 32
    tokens in 4 microbatches, against ``Model.loss`` on the whole batch
    (the reference test's rtol 2e-3; gradients rtol 5e-3 / atol 1e-4), no
    plain call."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, ModelKnobs
    from repro_torch.parallel.pipeline import pipeline_loss, place_pipeline
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import loss_and_grads
    cfg = get_config("smollm-135m", reduced=True)
    model = Model(cfg, ModelKnobs(kv_chunk=16, ssm_chunk=8), device="cuda")
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=g)
             for k in ("tokens", "labels")}
    rules = make_rules("cp").with_mesh(world1_pod_mesh)
    placed = place_pipeline(model, params, rules)
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(placed)]
    it = iter(leaves)
    tree = {k: {n: next(it) for n in sub} for k, sub in placed.items()}
    p0 = dict(ops.plain_calls)
    loss = pipeline_loss(model, rules, tree, batch, n_mb=4)
    grads = [t.full_tensor() for t in torch.autograd.grad(loss, leaves)]
    assert ops.plain_calls == p0
    want, want_g = loss_and_grads(model, params, {
        k: v.cuda() for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-3)
    for a, b in zip(grads, tree_leaves(want_g)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-3, atol=1e-4)
