"""Plain PyTorch versions of every kernel (mirror ``repro.kernels.ref``).

The CPU path of ``ops`` runs these, the tests hold them against the JAX
oracles and Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) x (K,N) -> (M,N) in a's dtype; f32 arithmetic."""
    return (a.float() @ b.float()).to(a.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) in f32, cast to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) -- GQA naive attention with
    the queries aligned to the end of the KV sequence."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, d).to(q.dtype)
