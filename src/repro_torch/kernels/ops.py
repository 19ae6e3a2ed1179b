"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors (mirrors ``repro.kernels.ops``, with its signatures and the
model-native ``(B, S, H, d)`` attention layout).

There is no fallback: a tensor that is not on the CPU goes to the kernel,
whose wrapper launches it or raises.  ``launches`` counts kernel launches
per kernel (the CPU path does not count); ``plain_calls`` counts the calls
that took a plain version (``kernels/ref.py``), so a run on the card can
show that it took none.

Gradients: where autograd is recording and an input requires grad, each op
runs as a ``torch.autograd.Function`` whose backward is a kernel too, chosen
by device the same way: matmul's backward is the forward kernel on
transposed views (dA = dC B^T, dB = A^T dC), RMSNorm's and flash
attention's are ``rmsnorm_bwd_cuda`` and ``flash_attention_bwd_cuda``
(plain: ``ref.rmsnorm_bwd_ref``, ``ref.flash_attention_bwd_ref``).  The
serving path, under ``torch.no_grad()`` or with no input that requires
grad, calls the forward directly, as before.  Flash attention records at
every (dk, dv) pair the forward takes, MLA's too, on either device.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import ref
from ._build import launches
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .matmul import matmul_cuda
from .rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda

__all__ = ["matmul", "rmsnorm", "flash_attention", "launches",
           "plain_calls"]

# calls that took a plain version, per kernel (forward and backward)
plain_calls: Dict[str, int] = {k: 0 for k in launches}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _plain(name: str) -> None:
    plain_calls[name] += 1


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _matmul_fwd(a, b):
    if _on_cpu(a, b):
        _plain("matmul")
        return ref.matmul_ref(a, b)
    return matmul_cuda(a, b)


def _rmsnorm_fwd(x, w, eps):
    if _on_cpu(x, w):
        _plain("rmsnorm")
        return ref.rmsnorm_ref(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


def _flash_fwd(q, k, v, causal, bk, scale, with_lse=False):
    if _on_cpu(q, k, v):
        _plain("flash_attention")
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=with_lse, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, bk=bk,
                                with_lse=with_lse, scale=scale)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _matmul_fwd(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        da = _matmul_fwd(dc, b.T) if ctx.needs_input_grad[0] else None
        db = _matmul_fwd(a.T, dc) if ctx.needs_input_grad[1] else None
        return da, db


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if _on_cpu(x, w, dy):
            _plain("rmsnorm_bwd")
            dx, dw = ref.rmsnorm_bwd_ref(x, w, dy, ctx.eps)
        else:
            dx, dw = rmsnorm_bwd_cuda(x, w, dy, ctx.eps)
        return dx, dw, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, bk, scale):
        o, lse = _flash_fwd(q, k, v, causal, bk, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bk, ctx.scale = causal, bk, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_cpu(q, k, v, do):
            _plain("flash_attention_bwd")
            grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=ctx.causal,
                                                scale=ctx.scale)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=ctx.causal, bk=ctx.bk,
                                             scale=ctx.scale)
        return (*grads, None, None, None)


def matmul(a, b):
    """(M, K) x (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if _records_grad(a, b):
        return _Matmul.apply(a, b)
    return _matmul_fwd(a, b)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., D); w: (D,); scale by (1 + w)."""
    if _records_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


def flash_attention(q, k, v, *, causal: bool = True, bk=None, scale=None):
    """q: (B, Sq, H, dk); k: (B, Skv, KVH, dk); v: (B, Skv, KVH, dv) ->
    (B, Sq, H, dv).  ``bk``: the KV chunk (the Pallas kernel's ``bk``;
    None: the serving default tile).  The plain version's result does not
    depend on it.  ``scale``: the scores' scale (None: 1/sqrt(dk), as the
    reference's ``softmax_scale``)."""
    if _records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, bk, scale)
    return _flash_fwd(q, k, v, causal, bk, scale)
