"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors (mirrors ``repro.kernels.ops``, with its signatures and the
model-native ``(B, S, H, d)`` attention layout).

There is no fallback: a tensor that is not on the CPU goes to the kernel,
whose wrapper launches it or raises.  ``launches`` counts kernel launches
per kernel (the CPU path does not count).
"""

from __future__ import annotations

import torch

from . import ref
from ._build import launches
from .flash_attention import flash_attention_cuda
from .matmul import matmul_cuda
from .rmsnorm import rmsnorm_cuda

__all__ = ["matmul", "rmsnorm", "flash_attention", "launches"]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def matmul(a, b):
    """(M, K) x (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if _on_cpu(a, b):
        return ref.matmul_ref(a, b)
    return matmul_cuda(a, b)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., D); w: (D,); scale by (1 + w)."""
    if _on_cpu(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) -> (B, Sq, H, d)."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
