"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors (mirrors ``repro.kernels.ops``, with its signatures and the
model-native ``(B, S, H, d)`` attention layout).

There is no fallback: a tensor that is not on the CPU goes to the kernel,
whose wrapper launches it or raises.  Fake tensors (the dry-run,
``launch/trace_cost.py``) are checked first: each op and its backward
returns empty fake outputs of the kernel's shapes, launches nothing, runs
no plain version and charges the kernel's own bytes and flops
(``cost.charge``).  A real tensor, on the CPU or the card, never takes that
branch.  ``launches`` counts kernel launches
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

DTensors (the sharded train step, ``parallel/sharding.py``): each op has a
placement rule (``matmul_rule``, ``rmsnorm_rule``, ``flash_rule``) that
names, mesh dim by mesh dim, the placements its inputs are redistributed
to, its output's, and its inputs' gradients'.  The op then runs the same
per-device dispatch on the local tensors (``parallel.sharding.on_shards``,
through ``local_map``), so a CUDA DTensor launches the kernels and a CPU one runs
the plain versions, as plain tensors do.  DTensor's own sharding
propagation cannot see into a ctypes launch; the rules stand in for it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import on_shards
from . import ref
from .cost import charge
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


def _fake(*tensors: torch.Tensor) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def _plain(name: str) -> None:
    plain_calls[name] += 1


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _matmul_fwd(a, b):
    if _fake(a, b):
        charge("matmul", a, b)
        return a.new_empty((a.shape[0], b.shape[1]))
    if _on_cpu(a, b):
        _plain("matmul")
        return ref.matmul_ref(a, b)
    return matmul_cuda(a, b)


def _rmsnorm_fwd(x, w, eps):
    if _fake(x, w):
        charge("rmsnorm", x, w)
        return torch.empty_like(x)
    if _on_cpu(x, w):
        _plain("rmsnorm")
        return ref.rmsnorm_ref(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


def _flash_fwd(q, k, v, causal, bk, scale, q_offset=None, with_lse=False):
    if _fake(q, k, v):
        charge("flash_attention", q, k, v, q_offset=q_offset)
        B, Sq, H, _ = q.shape
        o = q.new_empty((B, Sq, H, v.shape[-1]))
        return (o, q.new_empty((B, H, Sq), dtype=torch.float32)) \
            if with_lse else o
    if _on_cpu(q, k, v):
        _plain("flash_attention")
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=with_lse, scale=scale,
                                       q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, bk=bk,
                                with_lse=with_lse, scale=scale,
                                q_offset=q_offset)


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
        if _fake(x, w, dy):
            charge("rmsnorm_bwd", x, w)
            return torch.empty_like(x), torch.empty_like(w), None
        if _on_cpu(x, w, dy):
            _plain("rmsnorm_bwd")
            dx, dw = ref.rmsnorm_bwd_ref(x, w, dy, ctx.eps)
        else:
            dx, dw = rmsnorm_bwd_cuda(x, w, dy, ctx.eps)
        return dx, dw, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, bk, scale, q_offset):
        o, lse = _flash_fwd(q, k, v, causal, bk, scale, q_offset,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bk, ctx.scale = causal, bk, scale
        ctx.q_offset = q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _fake(q, k, v, do):
            charge("flash_attention_bwd", q, k, v, q_offset=ctx.q_offset)
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None, None, None, None)
        if _on_cpu(q, k, v, do):
            _plain("flash_attention_bwd")
            grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=ctx.causal,
                                                scale=ctx.scale,
                                                q_offset=ctx.q_offset)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=ctx.causal, bk=ctx.bk,
                                             scale=ctx.scale,
                                             q_offset=ctx.q_offset)
        return (*grads, None, None, None, None)


def _matmul_local(a, b):
    if _records_grad(a, b):
        return _Matmul.apply(a, b)
    return _matmul_fwd(a, b)


def _rmsnorm_local(x, w, eps):
    if _records_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


def _flash_local(q, k, v, causal, bk, scale, q_offset=None):
    if _records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, bk, scale, q_offset)
    return _flash_fwd(q, k, v, causal, bk, scale, q_offset)


def matmul(a, b):
    """(M, K) x (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    if is_distributed(a, b):
        return on_shards(_matmul_local, matmul_rule, a, b)
    return _matmul_local(a, b)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., D); w: (D,); scale by (1 + w)."""
    if is_distributed(x, w):
        return on_shards(lambda x_, w_: _rmsnorm_local(x_, w_, eps),
                         rmsnorm_rule, x, w)
    return _rmsnorm_local(x, w, eps)


def flash_attention(q, k, v, *, causal: bool = True, bk=None, scale=None,
                    q_offset=None):
    """q: (B, Sq, H, dk); k: (B, Skv, KVH, dk); v: (B, Skv, KVH, dv) ->
    (B, Sq, H, dv).  ``bk``: the KV chunk (the Pallas kernel's ``bk``;
    None: the serving default tile).  The plain version's result does not
    depend on it.  ``scale``: the scores' scale (None: 1/sqrt(dk), as the
    reference's ``softmax_scale``).  ``q_offset``: the key position of
    query 0 under ``causal`` (the Pallas kernel's; None: Skv - Sq, the
    queries are the last Sq positions).

    On DTensors each rank runs its own block of q's rows (``flash_rule``)
    at its global offset: ``q_offset`` plus the block's start along the
    sequence.  A trace on fake tensors (the dry-run) takes the last block's
    start, the rank that sees the most keys and that the step waits on."""
    if is_distributed(q, k, v):
        q_pl = flash_rule(q, k, v)[0][0]
        off = ref.query_offset(q.shape[1], k.shape[1], causal, q_offset) \
            + _block_start(q, q_pl, last=_fake(q.to_local()))
        return on_shards(
            lambda q_, k_, v_: _flash_local(q_, k_, v_, causal, bk, scale,
                                            off),
            flash_rule, q, k, v)
    return _flash_local(q, k, v, causal, bk, scale, q_offset)


# ---------------------------------------------------------------------------
# DTensors: per-op placement rules
# ---------------------------------------------------------------------------

_R = Replicate()


def is_distributed(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def _ranks_on(t, d: int) -> int:
    """The number of ranks that split dim ``d`` of DTensor ``t``."""
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements) if p.is_shard(d))


def _dim_ok(t, p) -> bool:
    """``p`` is a shard of a dim of ``t`` that its ranks split evenly."""
    return p.is_shard() and t.shape[p.dim] % _ranks_on(t, p.dim) == 0


def matmul_rule(a, b):
    """Placements for a (..., K) @ b (K, N), mesh dim by mesh dim, as an
    einsum's SPMD rule: A's rows (any dim but its last) sharded and B
    replicated give C's rows; A replicated and B's columns sharded give C's
    columns; both sharded on K give a ``Partial`` sum; both replicated give
    C replicated.  Anything else is gathered first (A's rows win over a
    sharded B, B's columns over a K-sharded A).  The gradient of an operand
    that is replicated on a mesh dim where the other is sharded is a
    partial sum over that dim (``Partial``); every other gradient has its
    operand's placement.  Returns (input placements, output placements,
    input gradient placements)."""
    ka = a.ndim - 1
    in_a, in_b, out, g_a, g_b = [], [], [], [], []
    for pa, pb in zip(a.placements, b.placements):
        if _dim_ok(a, pa) and pa.dim < ka:                # A's rows
            x = (pa, _R, Shard(pa.dim), pa, Partial())
        elif _dim_ok(b, pb) and pb.dim == 1:              # B's columns
            x = (_R, pb, Shard(ka), Partial(), pb)
        elif (_dim_ok(a, pa) and pa.dim == ka and _dim_ok(b, pb)
              and pb.dim == 0):                           # K on both
            x = (pa, pb, Partial(), pa, pb)
        else:
            x = (_R, _R, _R, _R, _R)
        for lst, p in zip((in_a, in_b, out, g_a, g_b), x):
            lst.append(p)
    return ((tuple(in_a), tuple(in_b)), tuple(out),
            (tuple(g_a), tuple(g_b)))


def rmsnorm_rule(x, w):
    """Rows (any dim of x but its last) stay as they are and the norm's
    dim is gathered; w is replicated, and its gradient is a partial sum
    over the mesh dims that shard x's rows."""
    D = x.ndim - 1
    in_x, g_w = [], []
    for px in x.placements:
        px = px if _dim_ok(x, px) and px.dim < D else _R
        in_x.append(px)
        g_w.append(Partial() if px.is_shard() else _R)
    in_x, rep = tuple(in_x), (_R,) * len(in_x)
    return (in_x, rep), in_x, (in_x, tuple(g_w))


def _block_start(q, placements, last: bool = False) -> int:
    """The start along q's dim 1 of this rank's block under ``placements``,
    whose mesh dims split it evenly, in mesh-dim order (as DTensor shards a
    dim held by several mesh dims); with ``last``, the last block's."""
    mesh = q.device_mesh
    coord = mesh.get_coordinate()
    lo, n = 0, q.shape[1]
    for i, p in enumerate(placements):
        if p.is_shard(1):
            n //= mesh.size(i)
            lo += (mesh.size(i) - 1 if last else coord[i]) * n
    return lo


def flash_rule(q, k, v):
    """Batch, heads and the queries' sequence may stay sharded.  Heads stay
    sharded on a mesh dim only where it splits both q's H and k's KVH heads
    evenly, so that each rank holds whole GQA groups (H / m query heads over
    their KVH / m KV heads).  On a mesh dim that splits q's sequence evenly
    q and the output keep their shard and k and v are gathered: each rank
    runs its own query rows against every key, at its block's offset
    (``flash_attention``), as the reference's attention runs on its
    sequence-sharded queries with global positions.  Every other placement
    is gathered.  dq has q's placement; dk and dv have k's and v's, but
    for a ``Partial`` sum on a sequence-split mesh dim (each rank's queries
    reach every key), which their redistribution back to k's and v's own
    placement reduce-scatters."""
    heads = _ranks_on(q, 2)
    in_q, in_kv, g_kv = [], [], []
    for pq in q.placements:
        if (pq.is_shard(0) and _dim_ok(q, pq)) or (
                pq.is_shard(2) and q.shape[2] % heads == 0
                and k.shape[2] % heads == 0):
            x = (pq, pq, pq)
        elif pq.is_shard(1) and _dim_ok(q, pq):
            x = (pq, _R, Partial())
        else:
            x = (_R, _R, _R)
        for lst, p in zip((in_q, in_kv, g_kv), x):
            lst.append(p)
    in_q, in_kv, g_kv = tuple(in_q), tuple(in_kv), tuple(g_kv)
    return (in_q, in_kv, in_kv), in_q, (in_q, g_kv, g_kv)
