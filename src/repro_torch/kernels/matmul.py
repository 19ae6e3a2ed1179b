"""Matrix product on the card: wrapper of ``csrc/matmul.cu``.

Port of ``repro.kernels.matmul`` (Pallas ``_matmul_kernel``).  The plain
version is ``ref.matmul_ref``; ``ops.matmul`` picks between the two by the
tensors' device.  A and B are passed with their strides, so a transposed
view (the tied head's ``embed.T``) is read in place, never copied.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p]


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N), CUDA tensors of one dtype (f32 or bf16), any
    strides -> (M, N) contiguous in that dtype; f32 accumulation."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    code = _build.check_inputs("matmul", a, b)
    (M, K), N = a.shape, b.shape[1]
    if (M + 63) // 64 >= 2 ** 16 or (N + 63) // 64 >= 2 ** 31:
        raise ValueError(f"matmul: ({M}, {N}) exceeds the grid")
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    launch = _build.entry("matmul", _ARGTYPES)
    err = launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                 a.stride(0), a.stride(1), b.stride(0), b.stride(1), code,
                 _build.stream())
    _build.check(err, "matmul")
    _build.launches["matmul"] += 1
    return c
