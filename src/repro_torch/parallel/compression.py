"""Blockwise int8 gradient compression (port of
``repro.parallel.compression``).

- ``simulate_int8_roundtrip`` quantizes a tensor to int8 blocks of
  ``BLOCK`` elements with an f32 scale each and dequantizes it: what a
  compressed wire format loses, applied to already-reduced gradients by the
  train step's ``grad_compression="int8"``;
- ``ErrorFeedback``: the residual that compression lost is added back to
  the next step's gradient (Karimireddy et al.), over the port's parameter
  trees (nested dicts of tensors, or one tensor);
- ``ring_allreduce_int8``: a ring reduce-scatter and all-gather over one
  mesh axis whose every hop carries int8 blocks and their f32 scales (a
  quarter of an f32 ring's bytes), the partial sums accumulated in f32 and
  requantized a hop, as the reference's ``shard_map`` ring; its
  ``ppermute`` to the next rank is ``dist.batch_isend_irecv`` on the
  axis's process group.

Plain tensor code and collectives, as the reference's is plain ``jnp`` and
``ppermute``; the same rounding (half to even) and clip, so both give the
same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

BLOCK = 256


def _pad_to(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    pad = (-n) % m
    if pad:
        x = torch.cat([x.reshape(-1), x.new_zeros(pad)])
    return x.reshape(-1), pad


def quantize_int8(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (q int8 (nb, BLOCK), scales f32 (nb,), pad)."""
    flat, pad = _pad_to(x.float(), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return q, scale, pad


def dequantize_int8(q, scale, pad, shape, dtype):
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def simulate_int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 0:
        return x
    q, s, pad = quantize_int8(x)
    return dequantize_int8(q, s, pad, x.shape, x.dtype)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


class ErrorFeedback:
    """e_{t+1} = g_t + e_t - C(g_t + e_t); apply returns C(g + e)."""

    @staticmethod
    def init(params):
        """f32 zeros shaped as each leaf of ``params``."""
        return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)

    @staticmethod
    def apply(grads, residual):
        """(the compressed gradients in each gradient's dtype, the new f32
        residuals), two trees shaped as ``grads``."""
        def one(g, e):
            tot = g.float() + e
            c = simulate_int8_roundtrip(tot)
            return c.to(g.dtype), tot - c
        out = _tree_map(one, grads, residual)
        return (_tree_map(lambda t: t[0], out),
                _tree_map(lambda t: t[1], out))


# ---------------------------------------------------------------------------
# the compressed ring over one mesh axis
# ---------------------------------------------------------------------------

def _shift(tensors, group, r: int, n: int):
    """Each of ``tensors`` sent to the group's rank (r + 1) % n and its
    counterpart received from (r - 1) % n (the reference's ``ppermute``
    with the permutation i -> i + 1)."""
    to = dist.get_global_rank(group, (r + 1) % n)
    frm = dist.get_global_rank(group, (r - 1) % n)
    got = [torch.empty_like(t) for t in tensors]
    ops_ = [dist.P2POp(dist.isend, t, to, group) for t in tensors] \
        + [dist.P2POp(dist.irecv, t, frm, group) for t in got]
    for req in dist.batch_isend_irecv(ops_):
        req.wait()
    return got


def ring_allreduce_int8(stacked, mesh, axis: str):
    """All-reduce per-shard contributions over ``axis`` with an int8 wire.

    ``stacked``: an (n, m) DTensor whose row i is shard i's contribution,
    sharded ``Shard(0)`` on ``axis`` (and replicated on the mesh's other
    dims).  Returns an (n, m) DTensor so placed whose every row equals the
    sum.  Ring reduce-scatter (n - 1 hops: after them rank r owns chunk (r
    + 1) % n, requantized) and ring all-gather (n - 1 hops); every hop's
    payload is the int8 blocks and their f32 scales, the partial sums kept
    in f32 between hops.  ``n == 1`` returns the input."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return stacked
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    x = stacked.to_local()[0]                          # (m,) this shard
    flat, pad = _pad_to(x.float(), BLOCK * n)
    chunks = flat.reshape(n, -1).clone()               # n ring chunks
    width = chunks.shape[1]

    # reduce-scatter: after n - 1 hops rank r owns chunk (r + 1) % n
    for i in range(n - 1):
        send_idx, recv_idx = (r - i) % n, (r - i - 1) % n
        q, s, p = quantize_int8(chunks[send_idx])
        q, s = _shift((q, s), group, r, n)
        chunks[recv_idx] = chunks[recv_idx] + dequantize_int8(
            q, s, p, (width,), torch.float32)
    own_idx = (r + 1) % n
    q, s, p = quantize_int8(chunks[own_idx])

    # all-gather: circulate the owned chunk n - 1 hops
    out = torch.zeros_like(chunks)
    out[own_idx] = dequantize_int8(q, s, p, (width,), torch.float32)
    for i in range(n - 1):
        q, s = _shift((q, s), group, r, n)
        arrived_owner = (r - i - 1) % n                # whose chunk this is
        out[(arrived_owner + 1) % n] = dequantize_int8(
            q, s, p, (width,), torch.float32)
    flat_out = out.reshape(-1)
    if pad:
        flat_out = flat_out[:-pad]
    row = flat_out.reshape(x.shape).to(x.dtype)[None]
    return DTensor.from_local(row, mesh, stacked.placements,
                              run_check=False)
