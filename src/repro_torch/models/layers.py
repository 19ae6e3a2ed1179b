"""Layer primitives of the dense llama block: norm, rope, GQA attention,
gated FFN (port of the dense subset of ``repro.models.layers``).

The kernels are the layers' compute: every norm goes through
``ops.rmsnorm``, prefill attention through ``ops.flash_attention`` and
every projection through ``ops.matmul`` (CUDA kernels on the card, plain
PyTorch on the CPU).  ``decode_attention`` is plain tensor code, as it is
in JAX.  Projection weights are 2-D, ``(D, H*dh)`` for q/k/v and
``(H*dh, D)`` for o (``models/convert.py`` reshapes the JAX
``(D, H, dh)``/``(H, dh, D)`` tensors).  The sharding annotations of the
JAX layers are no-ops without rules and are dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

_NEG_INF = -1e30
# attn_block's KV chunk where the caller names none (JAX layers.py's
# default); with it the flash kernel takes its serving tile
DEFAULT_KV_CHUNK = 1024


def rms_norm(x, w, eps: float = 1e-5):
    return ops.rmsnorm(x, w, eps=eps)


def linear(x, w):
    """x (..., K) @ w (K, N) through the matmul kernel."""
    y = ops.matmul(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def rope_tables(positions, dim: int, theta: float):
    """cos/sin tables for the given absolute positions; positions may be any
    shape, tables get a trailing (dim/2) axis."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., n_heads, dim); cos/sin: broadcastable (..., dim/2).

    Rotates pairs split at half (llama convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _t_col(t):
    """t scalar or (B,) -> column (1,1)/(B,1) for broadcasting with (B,S)."""
    return t.view(1, 1) if t.dim() == 0 else t[:, None]


def decode_attention(q, k, v, *, t, kv_positions):
    """Single-step attention against a KV cache.

    q: (B, 1, H, dk); k: (B, S, KVH, dk); v: (B, S, KVH, dv); t: 0-d or
    (B,) tensor.  Positions beyond ``t`` are masked (``kv_positions <= t``
    is kept, per row)."""
    B, _, H, dk = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, dk)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dk))
    valid = (kv_positions[None, :] <= _t_col(t))[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", (p / l).to(v.dtype).float(),
                       v.float())
    return out.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def gqa_project_qkv(p, x, cfg, positions):
    """x: (B,S,D) -> q (B,S,H,dh), k,v (B,S,KV,dh) with rope applied."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = linear(x, p["wq"]).view(B, S, cfg.n_heads, dh)
    k = linear(x, p["wk"]).view(B, S, cfg.n_kv_heads, dh)
    v = linear(x, p["wv"]).view(B, S, cfg.n_kv_heads, dh)
    cos, sin = rope_tables(positions, dh, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_block(p, x, cfg, *, positions, kv_chunk=DEFAULT_KV_CHUNK):
    """Full-sequence (train/prefill) GQA attention; returns (out, (k, v)).
    ``kv_chunk`` reaches the flash kernels as their KV tile ``bk``
    (``flash_attention.kv_tile``); the default keeps the serving tile."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = gqa_project_qkv(p, h, cfg, positions)
    bk = None if kv_chunk == DEFAULT_KV_CHUNK else kv_chunk
    o = ops.flash_attention(q, k, v, causal=True, bk=bk)
    out = linear(o.reshape(B, S, -1), p["wo"])
    return out, (k, v)


def attn_decode(p, x, cache_kv, cfg, *, t, kv_positions):
    """One-token GQA attention against the cache.  x: (B,1,D); cache_kv:
    (k, v), each (B, S, KV, dh), written in place at position t; returns
    (out, (k, v))."""
    B = x.shape[0]
    dh = cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = linear(h, p["wq"]).view(B, 1, cfg.n_heads, dh)
    k1 = linear(h, p["wk"]).view(B, 1, cfg.n_kv_heads, dh)
    v1 = linear(h, p["wv"]).view(B, 1, cfg.n_kv_heads, dh)
    cos, sin = rope_tables(_t_col(t), dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k1 = apply_rope(k1, cos, sin)
    k, v = cache_kv
    cache_update(k, k1, t)
    cache_update(v, v1, t)
    o = decode_attention(q, k, v, t=t, kv_positions=kv_positions)
    out = linear(o.reshape(B, 1, -1), p["wo"])
    return out, (k, v)


def cache_update(cache, new, t):
    """Write ``new`` (B, 1, ...) at sequence position ``t`` (0-d or (B,)
    tensor, each < S) of ``cache`` (B, S, ...).  In place: JAX blends a
    one-hot into a new array; here the rows are written where they lie."""
    B = cache.shape[0]
    rows = torch.arange(B, device=cache.device)
    cache[rows, t.expand(B)] = new[:, 0].to(cache.dtype)
    return cache


def ffn_block(p, x, cfg):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    g = linear(h, p["w_gate"])
    u = linear(h, p["w_up"])
    return linear(F.silu(g) * u, p["w_down"])
