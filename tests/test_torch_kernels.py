"""The port's kernels (repro_torch.kernels) against the JAX package.

The plain PyTorch versions against the JAX Pallas kernels (in interpret
mode, as tests/test_kernels.py runs them) and the jnp oracles, on the same
numpy inputs, over the JAX sweep's shapes, dtypes and tolerances; and the
kernel wrappers' and the build's checks, which need no card.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import matmul as jax_matmul
from repro.kernels import rmsnorm as jax_rmsnorm
from repro.kernels import ref as jax_ref
from repro.models.layers import chunked_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

MATMUL_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 96, 32), (8, 8, 8),
                 (512, 128, 256)]
RMSNORM_SHAPES = [(4, 64, 128), (3, 37, 96), (1, 1, 8), (2, 200, 256)]
FLASH_DIMS = [(2, 128, 128, 4, 2, 64),     # square causal GQA
              (1, 64, 256, 8, 8, 32),      # suffix queries (Sq < Skv)
              (2, 256, 256, 6, 2, 64),     # multi-tile both ways
              (1, 96, 96, 3, 1, 16)]       # MQA, non-128 sizes


def _both(a: np.ndarray, dtype: str):
    """One numpy f32 array as a JAX array and a CPU torch tensor of
    ``dtype`` (both round to bf16 the same way: to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- plain versions vs the JAX package (CPU) ----------------------------------

@pytest.mark.parametrize("mkn", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas_and_ref(mkn, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(7)
    ja, ta = _both(rng.standard_normal((M, K), np.float32), dtype)
    jb, tb = _both(rng.standard_normal((K, N), np.float32), dtype)
    got = _np(ops.matmul(ta, tb))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for want in (jax_matmul(ja, jb), jax_ref.matmul_ref(ja, jb)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(7)
    jx, tx = _both(rng.standard_normal(shape, np.float32), dtype)
    jw, tw = _both((rng.standard_normal(shape[-1:]) * 0.1)
                   .astype(np.float32), dtype)
    got = _np(ops.rmsnorm(tx, tw))
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    for want in (jax_rmsnorm(jx, jw), jax_ref.rmsnorm_ref(jx, jw)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dims", FLASH_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(dims, dtype):
    B, Sq, Skv, H, KVH, d = dims
    rng = np.random.default_rng(7)
    jq, tq = _both(rng.standard_normal((B, Sq, H, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, Skv, KVH, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, Skv, KVH, d), np.float32), dtype)
    got = _np(ops.flash_attention(tq, tk, tv, causal=True))
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    for want in (jax_flash_attention(jq, jk, jv, causal=True),
                 jax_ref.flash_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


def test_flash_attention_plain_matches_model_reference_path():
    """The port's attention and the JAX model's chunked_attention agree."""
    B, S, H, KVH, d = 2, 64, 4, 2, 32
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, S, n, d), np.float32)
               for n in (H, KVH, KVH))
    pos = jnp.arange(S)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=pos, kv_positions=pos, causal=True,
                             kv_chunk=16)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


def test_cpu_path_counts_no_launches():
    before = dict(ops.launches)
    x = torch.ones(3, 8)
    ops.rmsnorm(x, torch.zeros(8))
    ops.matmul(x, torch.ones(8, 2))
    ops.flash_attention(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 1, 8),
                        torch.ones(1, 4, 1, 8))
    assert ops.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never takes the plain path itself: the CPU choice
    is made in ops, by device, and a wrapper given CPU tensors raises."""
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(x, torch.ones(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.zeros(8))
    q = torch.ones(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])


def test_flash_wrapper_rejects_unsupported_shapes():
    q = torch.ones(1, 8, 2, 24)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError, match="Sq"):
        flash_attention_cuda(q, q[:, :4], q[:, :4])


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    """An edit to a kernel source or to the shared header renames its
    library, so a stale build is never loaded."""
    (tmp_path / "common.cuh").write_text("// a\n")
    (tmp_path / "k.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    (tmp_path / "k.cu").write_text("// b2\n")
    second = _build._lib_path("k")
    (tmp_path / "common.cuh").write_text("// a2\n")
    third = _build._lib_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
