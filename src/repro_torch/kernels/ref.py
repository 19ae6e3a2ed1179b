"""Plain PyTorch versions of every kernel (mirror ``repro.kernels.ref``).

The CPU path of ``ops`` runs these, the tests hold them against the JAX
oracles and Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  The backward passes are written out as explicit
formulas (``rmsnorm_bwd_ref``, ``flash_attention_bwd_ref``), the same ones
the backward kernels compute; the tests hold them against
``torch.autograd`` of the forward versions and against ``jax.grad``.
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


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-5):
    """Gradients of ``rmsnorm_ref`` for output gradient dy: (dx in x's
    dtype, dw in w's dtype), with r = rsqrt(mean x^2 + eps):
    dx = r (1 + w) dy - x r^3 / D sum(dy (1 + w) x), dw = sum_rows dy x r."""
    D = x.shape[-1]
    xf, dyf, w1 = x.float(), dy.float(), 1.0 + w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    s = (dyf * w1 * xf).sum(dim=-1, keepdim=True)
    dx = r * w1 * dyf - xf * (r ** 3) * (s / D)
    dw = (dyf * xf * r).reshape(-1, D).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _scaled(x, d: int, scale):
    """x times the scale: ``scale``, or divided by sqrt(d) where it is
    None."""
    return x / math.sqrt(d) if scale is None else x * scale


def query_offset(Sq: int, Skv: int, causal: bool, q_offset=None) -> int:
    """The key position of query 0 (the Pallas kernel's ``q_offset``):
    ``q_offset``, or Skv - Sq where it is None (the queries are the last Sq
    positions).  Under ``causal`` a given offset must leave every query a
    key and see no key past Skv: 0 <= q_offset and q_offset + Sq <= Skv."""
    if q_offset is None:
        return Skv - Sq
    q_offset = int(q_offset)
    if causal and (q_offset < 0 or q_offset + Sq > Skv):
        raise ValueError(f"flash_attention: causal q_offset {q_offset} + Sq "
                         f"{Sq} outside [0, Skv {Skv}]")
    return q_offset


def _gqa_scores(q, k, causal: bool, scale=None, q_offset=None):
    """Scaled (``scale``; None: 1/sqrt(dk)), masked scores (B, KVH, G, Sq,
    Skv) in f32; query i sits at key position ``q_offset`` + i (None: Skv -
    Sq + i)."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, d).float()
    s = _scaled(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()), d, scale)
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(
            query_offset(Sq, Skv, causal, q_offset))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return s


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        return_lse: bool = False, scale=None,
                        q_offset=None):
    """q: (B, Sq, H, dk); k: (B, Skv, KVH, dk); v: (B, Skv, KVH, dv) --
    GQA naive attention, query i at key position ``q_offset`` + i (None:
    the queries aligned to the end of the KV sequence, Skv - Sq + i),
    scores scaled by ``scale`` (None: 1/sqrt(dk)) -> (B, Sq, H, dv).
    ``return_lse``: also the rows' log-sum-exp of the scaled scores, f32
    (B, H, Sq), which the backward pass recomputes the probabilities
    from."""
    B, Sq, H, _ = q.shape
    s = _gqa_scores(q, k, causal, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            scale=None, q_offset=None):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` for output
    gradient do (o's shape, (B, Sq, H, dv)), recomputed from the saved lse
    as the backward kernel does (FlashAttention-2), with c the forward's
    scale (None: 1/sqrt(dk)) and ``q_offset``: P = exp(S - lse), Dl =
    rowsum(do o), dV = P^T do and dK = c dS^T q summed over the G query
    heads of a KV head, dS = P (do V^T - Dl), dq = c dS K.  dq and dk come
    out dk wide, dv dv wide; a key no query sees gets dk = dv = 0."""
    B, Sq, H, dk = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    G = H // KVH
    s = _gqa_scores(q, k, causal, scale, q_offset)
    p = torch.exp(s - lse.reshape(B, KVH, G, Sq, 1))
    dog = do.reshape(B, Sq, KVH, G, dv).float()
    dl = (dog * o.reshape(B, Sq, KVH, G, dv).float()).sum(-1)
    dvg = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = _scaled(p * (dp - dl.permute(0, 2, 3, 1)[..., None]), dk, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dkg = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                       q.reshape(B, Sq, KVH, G, dk).float())
    return (dq.reshape(B, Sq, H, dk).to(q.dtype), dkg.to(k.dtype),
            dvg.to(v.dtype))
