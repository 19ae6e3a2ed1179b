"""Layer primitives: norm, rope, GQA and MLA attention, gated FFN (port of
``repro.models.layers``).

The kernels are the layers' compute: every norm goes through
``ops.rmsnorm``, prefill attention through ``ops.flash_attention`` and
every projection through ``ops.matmul`` (CUDA kernels on the card, plain
PyTorch on the CPU).  What stays plain tensor code, as it is plain
``jnp`` outside any Pallas kernel in JAX, is the contractions between
activations: ``decode_attention``, MLA's latent scores at decode, and the
recurrent scans of ``ssm.py`` (Mamba's ``h . c``, mLSTM's ``C . q`` and
``n . q`` and its chunkwise L x L products and state updates, the gates
and the causal conv); the weight products inside the scans (sLSTM's
recurrent ``r``) go through ``ops.matmul``.  Projection weights are
2-D, ``(D, H*dh)`` for q/k/v and ``(H*dh, D)`` for o; MLA's ``wq_b``,
``wk_b`` and ``wv_b`` are ``(r, H*d)`` (``models/convert.py`` reshapes
the JAX ``(D, H, dh)``/``(H, dh, D)``/``(r, H, d)`` tensors).

The sharding annotations are the reference's
(``parallel.sharding.annotate``): no-ops on plain tensors or without
rules, a redistribute of a DTensor under rules.  On DTensors (the serving
engine under rules) the decode path writes its cache in place rank by
rank (``cache_update``): each rank writes the rows of its batch block
whose position falls in its block of the sequence, and nothing of the
cache moves; the position tables and masks, which every rank computes
whole, join the DTensors replicated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..parallel.sharding import (annotate, local_range, on_shards,
                                 replicate_like)
from . import remat

_NEG_INF = -1e30
_R = Replicate()
# attn_block's KV chunk where the caller names none (JAX layers.py's
# default); with it the flash kernel takes its serving tile
DEFAULT_KV_CHUNK = 1024


def rms_norm(x, w, eps: float = 1e-5):
    return ops.rmsnorm(x, w, eps=eps)


def _linear_local(x, w):
    y = remat.product(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def linear(x, w):
    """x (..., K) @ w (K, N) through the matmul kernel: a projection, a
    product with no batch dimension, whose output remat "dots" keeps
    (``remat.product``).  On DTensors under ``ops.matmul_rule`` with x's
    leading dims as its rows, each rank's local product as on one device."""
    if ops.is_distributed(x, w):
        return ops.on_shards(_linear_local, ops.matmul_rule, x, w)
    return _linear_local(x, w)


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


def _softmax(s, reduce=None):
    """Softmax over s's last dim; ``reduce(x, op)`` combines the row
    maxima and sums across the ranks that hold the other parts of that
    dim (a sequence split over a mesh dim)."""
    m = s.amax(dim=-1, keepdim=True)
    if reduce is not None:
        m = reduce(m, "max")
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if reduce is not None:
        l = reduce(l, "sum")
    return p / l


def _decode_attention_local(q, k, v, t_col, kv_positions, reduce=None):
    B, _, H, dk = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, dk)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(dk))
    valid = (kv_positions[None, :] <= t_col)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = _softmax(s, reduce)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    if reduce is not None:
        out = reduce(out, "sum")
    return out.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def decode_attention(q, k, v, *, t, kv_positions):
    """Single-step attention against a KV cache.

    q: (B, 1, H, dk); k: (B, S, KVH, dk); v: (B, S, KVH, dv); t: 0-d or
    (B,) tensor.  Positions beyond ``t`` are masked (``kv_positions <= t``
    is kept, per row).  A DTensor cache runs under
    ``split_sequence_rule``: each rank attends over its own block of the
    cache, and the softmax's row maxima and sums and the output are
    all-reduced over the mesh dims that split the sequence."""
    if isinstance(k, DTensor):
        return _on_cache_shards(_decode_attention_local, (q,), (k, v), t,
                                kv_positions)
    return _decode_attention_local(q, k, v, _t_col(t), kv_positions)


def _reduce_over(mesh, dims):
    """``reduce(x, op)``: x all-reduced with ``op`` over each mesh dim of
    ``dims`` in turn (None where there is none)."""
    if not dims:
        return None

    def reduce(x, op):
        for d in dims:
            x = funcol.all_reduce(x, op, (mesh, d))
        return funcol.wait_tensor(x) if isinstance(
            x, funcol.AsyncCollectiveTensor) else x
    return reduce


def split_sequence_rule(n_q: int, heads: bool):
    """The placement rule of an attention over a decode cache: ``n_q``
    query tensors (B, ...) then the cache's leaves (B, S, ...) then the
    positions t (B,) and the sequence's positions (S,).  The cache keeps
    its batch and sequence splits, and with ``heads`` its dim 2's (GQA's
    KV heads; a split of them holds whole groups of q's heads), and is
    gathered on its other dims; the queries and t take the batch split,
    the queries also the heads'; the sequence's positions take its split.
    The output has the queries' placements.  Serving only: the gradients
    are stated as the inputs' placements."""
    def rule(*tensors):
        cache = tensors[n_q:-2]
        pc = tuple(p if p.is_shard() and (p.dim <= 1 or heads and p.dim == 2)
                   else _R for p in cache[0].placements)
        pq = tuple(p if p.is_shard() and p.dim != 1 else _R for p in pc)
        pt = tuple(p if p.is_shard(0) else _R for p in pc)
        pos = tuple(Shard(0) if p.is_shard(1) else _R for p in pc)
        ins = (pq,) * n_q + (pc,) * len(cache) + (pt, pos)
        return ins, pq, ins
    return rule


def _on_cache_shards(fn, queries, cache, t, kv_positions, *args,
                     heads=True):
    """``fn(*queries, *cache, t_col, positions, *args, reduce=)`` on each
    rank's local blocks under ``split_sequence_rule``; ``reduce``
    all-reduces over the mesh dims that split the sequence."""
    ref = cache[0]
    reduce = _reduce_over(ref.device_mesh, [
        i for i, p in enumerate(ref.placements) if p.is_shard(1)])
    t = replicate_like(t.expand(ref.shape[0]), ref)
    kv_positions = replicate_like(kv_positions, ref)
    n_q = len(queries)

    def local(*ts):
        return fn(*ts[:-2], ts[-2][:, None], ts[-1], *args, reduce=reduce)
    return on_shards(local, split_sequence_rule(n_q, heads), *queries,
                     *cache, t, kv_positions)


def gqa_project_qkv(p, x, cfg, positions):
    """x: (B,S,D) -> q (B,S,H,dh), k,v (B,S,KV,dh) with rope applied."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = linear(x, p["wq"]).view(B, S, cfg.n_heads, dh)
    k = linear(x, p["wk"]).view(B, S, cfg.n_kv_heads, dh)
    v = linear(x, p["wv"]).view(B, S, cfg.n_kv_heads, dh)
    cos, sin = (replicate_like(t, q)
                for t in rope_tables(positions, dh, cfg.rope_theta))
    q = annotate(apply_rope(q, cos, sin), "batch", "seq", "heads", None)
    k = annotate(apply_rope(k, cos, sin), "batch", "seq", "kv_heads", None)
    v = annotate(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def attn_block(p, x, cfg, *, positions, kv_chunk=DEFAULT_KV_CHUNK):
    """Full-sequence (train/prefill) GQA attention; returns (out, (k, v)).
    ``kv_chunk`` reaches the flash kernels as their KV tile ``bk``
    (``flash_attention.kv_tile``); the default keeps the serving tile."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = gqa_project_qkv(p, h, cfg, positions)
    bk = None if kv_chunk == DEFAULT_KV_CHUNK else kv_chunk
    o = ops.flash_attention(q, k, v, causal=True, bk=bk)
    o = annotate(o, "batch", "seq", "heads", None)
    out = linear(o.reshape(B, S, -1), p["wo"])
    return annotate(out, "batch", "seq", "embed"), (k, v)


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
    cos, sin = (replicate_like(a, q)
                for a in rope_tables(_t_col(t), dh, cfg.rope_theta))
    q = apply_rope(q, cos, sin)
    k1 = apply_rope(k1, cos, sin)
    k, v = cache_kv
    cache_update(k, k1, t)
    cache_update(v, v1, t)
    o = decode_attention(q, k, v, t=t, kv_positions=kv_positions)
    out = linear(o.reshape(B, 1, -1), p["wo"])
    return annotate(out, "batch", None, "embed"), (k, v)


def cache_update(cache, new, t):
    """Write ``new`` (B, 1, ...) at sequence position ``t`` (0-d or (B,)
    tensor, each < S) of ``cache`` (B, S, ...).  In place: JAX blends a
    one-hot into a new array; here the rows are written where they lie.
    A DTensor cache is written rank by rank (``_cache_update_shards``)."""
    B = cache.shape[0]
    if isinstance(cache, DTensor):
        _cache_update_shards(cache, new, t.expand(B))
        return cache
    rows = torch.arange(B, device=cache.device)
    cache[rows, t.expand(B)] = new[:, 0].to(cache.dtype)
    return cache


def _cache_update_shards(cache, new, t):
    """The write rule of a cache sharded over batch (dim 0), the sequence
    (dim 1) and any trailing dim: ``new`` is redistributed to the cache's
    placements with the sequence dim whole (its one position is on every
    rank of that dim), and each rank writes the rows of its batch block
    whose position ``t`` (the same (B,) tensor on every rank) falls in its
    sequence block, at that position less the block's offset.  The other
    rows are rewritten with what they hold (a gather and a scatter, no host
    sync).  Nothing of the cache moves."""
    mesh = cache.device_mesh
    want = tuple(Replicate() if p.is_shard(1) else p
                 for p in cache.placements)
    src = new.redistribute(mesh, want).to_local()
    b0, nb = local_range(cache, 0)
    s0, ns = local_range(cache, 1)
    loc = cache.to_local()
    pos = t[b0:b0 + nb].to(loc.device) - s0
    inside = ((pos >= 0) & (pos < ns)).view((nb,) + (1,) * (loc.ndim - 2))
    rows = torch.arange(nb, device=loc.device)
    pos = pos.clamp(0, ns - 1)
    with torch.no_grad():
        loc[rows, pos] = torch.where(inside, src[:, 0].to(loc.dtype),
                                     loc[rows, pos])


def mla_project_q(p, h, cfg):
    """h (B, S, D) -> q (B, S, H, d_nope + d_rope): the low-rank query
    (``wq_a``, its norm ``q_ln``, ``wq_b``), rope not yet applied."""
    m = cfg.mla
    B, S, _ = h.shape
    ql = rms_norm(linear(h, p["wq_a"]), p["q_ln"], cfg.norm_eps)
    return linear(ql, p["wq_b"]).view(B, S, cfg.n_heads, m.d_nope + m.d_rope)


def _mla_latent(p, h, cfg, cos, sin):
    """h (B, S, D) -> (c_kv (B, S, kv_lora) normed, k_rope (B, S, d_rope)
    with rope): the latent that MLA caches."""
    m = cfg.mla
    kv = linear(h, p["wkv_a"])
    ckv = rms_norm(kv[..., :m.kv_lora], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora:], cos, sin)[:, :, 0, :]
    return ckv, k_rope


def mla_block(p, x, cfg, *, positions, kv_chunk=DEFAULT_KV_CHUNK):
    """MLA train/prefill; returns (out, (c_kv, k_rope)), the latent cache.

    K and V are expanded from the latent once for the whole sequence
    (``c_kv @ wk_b`` and ``c_kv @ wv_b``, one matmul launch each) and the
    heads go through the flash kernel at (dk, dv) = (d_nope + d_rope, d_v)
    with the scale 1/sqrt(d_nope + d_rope).  The reference expands them a
    KV chunk at a time inside its online-softmax scan (``_MLAExpand``), so
    that they never exist at full length; the result is the same, and at
    serving lengths (prompts of at most a few dozen tokens) the full
    expansion is small.  ``kv_chunk`` reaches the kernel as its KV tile,
    as in ``attn_block``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = mla_project_q(p, h, cfg)
    cos, sin = (replicate_like(t, q)
                for t in rope_tables(positions, m.d_rope, cfg.rope_theta))
    q = torch.cat([q[..., :m.d_nope],
                   apply_rope(q[..., m.d_nope:], cos, sin)], dim=-1)
    q = annotate(q, "batch", "seq", "heads", None)
    ckv, k_rope = _mla_latent(p, h, cfg, cos, sin)
    ckv = annotate(ckv, "batch", "seq", "lora")
    k_nope = linear(ckv, p["wk_b"]).view(B, S, H, m.d_nope)
    v = linear(ckv, p["wv_b"]).view(B, S, H, m.d_v)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.d_rope)
                   .to(k_nope.dtype)], dim=-1)
    bk = None if kv_chunk == DEFAULT_KV_CHUNK else kv_chunk
    o = ops.flash_attention(q, k, v, causal=True, bk=bk,
                            scale=1.0 / math.sqrt(m.d_nope + m.d_rope))
    o = annotate(o, "batch", "seq", "heads", None)
    out = linear(o.reshape(B, S, H * m.d_v), p["wo"])
    return annotate(out, "batch", "seq", "embed"), (ckv, k_rope)


def _one_token(t):
    """A decode activation (B, 1, ...) with its token dim whole: the
    ``seq`` spec splits a dim of 1 only over a mesh dim of 1, and a view
    or index of a split dim is not one DTensor takes."""
    if isinstance(t, DTensor) and any(p.is_shard(1) for p in t.placements):
        t = t.redistribute(t.device_mesh, tuple(
            Replicate() if p.is_shard(1) else p for p in t.placements))
    return t


def per_head_matmul(x, w, width: int, *, transposed: bool):
    """x (B, H, K) -> (B, H, N): head i's rows times head i's block of
    ``width`` columns of the 2-D weight ``w`` (r, H*width), the block
    itself (K = r, N = width) or its transpose (K = width, N = r).  One
    matmul launch a head, on strided views: nothing is copied.  On
    DTensors x's heads and the whole weight are gathered once, so that
    each head's slices are rank-local; each launch then goes through the
    matmul's placement rule."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        x = x.redistribute(mesh, tuple(Replicate() if p.is_shard(1) else p
                                       for p in x.placements))
        w = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
    out = []
    for i in range(x.shape[1]):
        b = w[:, i * width:(i + 1) * width]
        out.append(ops.matmul(x[:, i], b.T if transposed else b))
    return torch.stack(out, dim=1)


def _latent_attention_local(q_lat, q_rope, ckv, k_rope, t_col,
                            kv_positions, scale, reduce=None):
    """MLA's attention in the latent space: scores of q_lat (B, H, r)
    against the latent cache and of q_rope (B, H, dr) against the rope
    keys, masked, softmax, and the weighted latent rows (B, H, r)."""
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(),
                        k_rope.float())) * scale
    valid = (kv_positions[None, :] <= t_col)[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    pr = _softmax(s, reduce)
    o = torch.einsum("bhs,bsr->bhr", pr.to(ckv.dtype).float(), ckv.float())
    return o if reduce is None else reduce(o, "sum")


def mla_decode(p, x, cache, cfg, *, t, kv_positions):
    """Absorbed-matmul MLA decode: attention runs in the latent space and
    the per-head K/V are never expanded.  x: (B, 1, D); cache = (c_kv (B,
    S, kv_lora), k_rope (B, S, d_rope)), written in place at position t;
    returns (out, cache).

    Per head h, ``q_lat = q_nope . wk_b[h]^T`` and ``o = o_lat . wv_b[h]``
    are projections, so each is a matmul launch on strided views of the
    2-D weights (``per_head_matmul``: 2 H launches a layer); the latent
    scores, the softmax and ``o_lat`` are plain tensor code."""
    m = cfg.mla
    B = x.shape[0]
    H, dn, dv = cfg.n_heads, m.d_nope, m.d_v
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _one_token(mla_project_q(p, h, cfg))           # (B, 1, H, dn + dr)
    cos, sin = (replicate_like(a, q)
                for a in rope_tables(_t_col(t), m.d_rope, cfg.rope_theta))
    q_rope = apply_rope(q[..., dn:], cos, sin)
    ckv1, kr1 = _mla_latent(p, h, cfg, cos, sin)
    ckv, k_rope = cache
    cache_update(ckv, ckv1, t)
    cache_update(k_rope, kr1, t)

    # absorb W_uk into q: q_lat (B, H, r) = q_nope . W_uk, head by head
    q_lat = per_head_matmul(q[:, 0, :, :dn], p["wk_b"], dn, transposed=True)
    scale = 1.0 / math.sqrt(dn + m.d_rope)
    if isinstance(ckv, DTensor):
        o_lat = _on_cache_shards(_latent_attention_local,
                                 (q_lat, q_rope[:, 0]), (ckv, k_rope), t,
                                 kv_positions, scale, heads=False)
    else:
        o_lat = _latent_attention_local(q_lat, q_rope[:, 0], ckv, k_rope,
                                        _t_col(t), kv_positions, scale)
    o_lat = o_lat.to(x.dtype)
    # absorb W_uv: o (B, H, dv) = o_lat . W_uv, head by head
    o = per_head_matmul(o_lat, p["wv_b"], dv, transposed=False)
    out = linear(o.reshape(B, 1, H * dv), p["wo"])
    return annotate(out, "batch", None, "embed"), (ckv, k_rope)


def ffn_block(p, x, cfg):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    g = annotate(linear(h, p["w_gate"]), "batch", "seq", "ffn")
    u = annotate(linear(h, p["w_up"]), "batch", "seq", "ffn")
    y = linear(F.silu(g) * u, p["w_down"])
    return annotate(y, "batch", "seq", "embed")
