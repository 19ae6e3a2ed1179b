"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  No JAX here, so they run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes: the JAX test sweep's (tests/test_kernels.py), plus the serving
path's full-width ones (smollm-135m: d_model 576, 9/3 heads of 64, the
49152-wide tied head read through a transposed view), at its tolerances.
"""

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
