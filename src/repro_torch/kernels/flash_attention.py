"""Causal GQA flash attention on the card: wrapper of
``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention`` (Pallas ``_flash_kernel``).  The
plain version is ``ref.flash_attention_ref``; ``ops.flash_attention`` picks
between the two by the tensors' device.  The wrapper takes the model-native
``(B, S, H, d)`` layout and passes the (b, s, h) strides to the kernel, so
nothing is transposed or copied (the JAX dispatch transposed into the
kernel's ``(B, H, S, d)``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) CUDA tensors of one dtype ->
    (B, Sq, H, d).  With ``causal`` the queries are the last Sq positions
    of the KV sequence, so Sq <= Skv."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KVH, d) or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} KV heads")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal Sq {Sq} > Skv {Skv}")
    if B >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"flash_attention: grid ({B}, {H}) too large")
    code = _build.check_inputs("flash_attention", q, k, v)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    launch = _build.entry("flash_attention", _ARGTYPES)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KVH, Sq, Skv, d, *strides, 1.0 / math.sqrt(d),
                 int(causal), code, _build.stream())
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return o
