"""RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Port of ``repro.kernels.rmsnorm`` (Pallas ``_rmsnorm_kernel``).  The plain
version is ``ref.rmsnorm_ref``; ``ops.rmsnorm`` picks between the two by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """x: (..., D) CUDA tensor (f32 or bf16); w: (D,).  Rows are the
    flattened leading dims; the output has x's shape and dtype."""
    D = x.shape[-1]
    if tuple(w.shape) != (D,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} != ({D},)")
    code = _build.check_inputs("rmsnorm", x)
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    x2 = x.reshape(-1, D)
    if D and x2.stride(1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows} rows exceed the grid")
    y = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0 or D == 0:
        return y.reshape(x.shape)
    wf = w.float().contiguous()
    launch = _build.entry("rmsnorm", _ARGTYPES)
    err = launch(x2.data_ptr(), wf.data_ptr(), y.data_ptr(), rows, D,
                 x2.stride(0), y.stride(0), float(eps), code, _build.stream())
    _build.check(err, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return y.reshape(x.shape)
