"""Mixture-of-experts FFN on one device (port of ``repro.models.moe``):
sort-based capacity dispatch, the dense decoy, and shared experts.

The dispatch is a tuning knob of the step (``ModelKnobs.moe_dispatch``,
``StepKnobs.moe_dispatch`` in ``tune/lm_study.py``):

- ``sort``: argsort the token-expert pairs by expert, pack each expert's
  first ``cap`` tokens into an ``(E, cap, D)`` buffer, run every expert on
  its rows and gather the outputs back.  Pairs beyond an expert's capacity
  are dropped, as in JAX;
- ``dense``: every expert on every token, combined by the gate matrix
  (tiny configurations only);
- ``a2a``: JAX's expert-parallel ``shard_map`` dispatch.  With no mesh it
  falls back to ``sort``, which is all a single device runs; the
  expert-parallel regimes (``_ep_dispatch``, ``_capacity``,
  ``_local_pack``, ``_local_combine``, ``_gather_weight``) wait for the
  multi-GPU port (``torch.distributed``).

Every product goes through ``ops.matmul``: the router, and three launches
per expert (gate, up, down), so 3E expert launches a layer whatever the
dispatch.  Argsort, bincount, cumsum and the index writes are plain tensor
code, as they are plain ``jnp`` in JAX.  Two choices keep the card's
result a fixed function of its inputs: the argsort is stable (as
``jnp.argsort`` is), so the card drops the same pairs as JAX; and the
combine un-permutes the pairs and sums each token's ``k`` contributions in
index order, where JAX scatter-adds (``index_add_`` on CUDA adds by
atomics in no fixed order).

As in the reference, the FFN's ``ln`` weight is not read: the router and
the experts see the un-normalized residual.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L

DISPATCHES = ("a2a", "sort", "dense")


def router_topk(logits, k: int, *, renormalize: bool = True):
    """logits (T, E) -> (gates (T, k) f32, idx (T, k)): softmax in f32,
    top k, renormalized.  Ties keep the lower index first, as ``lax.top_k``
    does: a stable descending sort (``torch.topk`` breaks them in no fixed
    order).  Ties are exact wherever logits are: a zero router column or a
    zero token row, and more often in bf16."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    if renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, idx


def sort_capacity(tk: int, n_experts: int, capacity_factor: float) -> int:
    """Rows per expert of the sort dispatch for ``tk`` token-expert pairs
    (Python's ``round``, as JAX), padded to a multiple of 256 from 256
    pairs on."""
    cap = int(max(1, round(tk / n_experts * capacity_factor)))
    return -(-cap // 256) * 256 if tk >= 256 else cap


def _expert_ffn(p, x):
    """x: (E, C, D) -> (E, C, D), each expert's gated MLP on its rows:
    three matmul launches an expert.  The stacks are unbound once, so the
    backward stacks each weight's E gradients in one pass (a gradient per
    indexed expert would fill and add a whole (E, D, F) tensor E times).
    The products are the reference's ``ecd,edf->ecf``, which have a batch
    dimension: they call ``ops.matmul`` itself, not ``layers.linear``, so
    remat "dots" recomputes them."""
    out = []
    for xe, wg, wu, wd in zip(*(t.unbind(0) for t in (
            x, p["w_gate"], p["w_up"], p["w_down"]))):
        g = ops.matmul(xe, wg)
        u = ops.matmul(xe, wu)
        out.append(ops.matmul(F.silu(g) * u, wd))
    return torch.stack(out)


def _sort_dispatch(p, xf, gates, idx, moe):
    """(y (T, D), kept (T, k) bool): the capacity dispatch."""
    T, D = xf.shape
    E, k = moe.n_experts, moe.top_k
    Tk = T * k
    cap = sort_capacity(Tk, E, moe.capacity_factor)
    fidx = idx.reshape(Tk)
    order = torch.argsort(fidx, stable=True)
    se, st, sg = fidx[order], order // k, gates.reshape(Tk)[order]
    # position within expert: running index minus the expert's start
    counts = torch.bincount(fidx, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tk, device=xf.device) - starts[se]
    keep = pos < cap
    slot = se * cap + pos
    # dropped pairs land in one extra row, cut off before the experts (a
    # mask would sync the host with the device)
    buf = xf.new_zeros(E * cap + 1, D).index_put(
        (torch.where(keep, slot, E * cap),), xf[st])
    ye = _expert_ffn(p, buf[:-1].view(E, cap, D)).reshape(E * cap, D)
    y_sorted = ye[torch.where(keep, slot, 0)] \
        * (keep * sg).to(xf.dtype)[:, None]
    # un-permute, then each token's k contributions summed in index order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Tk, device=xf.device)
    y_pairs = y_sorted[inv].view(T, k, D)
    y = y_pairs[:, 0]
    for j in range(1, k):
        y = y + y_pairs[:, j]
    return y, keep[inv].view(T, k)


def _dense_dispatch(p, xf, gates, idx, moe):
    """(y (T, D), kept): every expert on every token, weighted by the
    (T, E) gate matrix, summed over experts in order."""
    T, D = xf.shape
    E = moe.n_experts
    h = _expert_ffn(p, xf.expand(E, T, D))
    gate_mat = xf.new_zeros(T, E).scatter(1, idx, gates)
    y = h[0] * gate_mat[:, :1]
    for e in range(1, E):
        y = y + h[e] * gate_mat[:, e:e + 1]
    return y, torch.ones_like(idx, dtype=torch.bool)


def moe_ffn(p, x, cfg, *, dispatch: str = "a2a",
            routing: Optional[List] = None):
    """x: (B, S, D) -> (B, S, D).  p holds router (D, E), expert stacks
    (E, D, F)/(E, F, D), and the shared experts' 2-D weights where
    ``cfg.moe.n_shared``.  ``routing``: a list to which the layer appends
    ``(idx (T, k), kept (T, k))``, the experts chosen per token and which
    of those pairs were computed (all of them under ``dense``)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {dispatch!r}")
    moe = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx = router_topk(L.linear(xf, p["router"]).float(), moe.top_k)
    gates = gates.to(x.dtype)
    if dispatch == "dense":
        y, kept = _dense_dispatch(p, xf, gates, idx, moe)
    else:                       # "a2a" with no mesh is "sort"
        y, kept = _sort_dispatch(p, xf, gates, idx, moe)
    if routing is not None:
        routing.append((idx, kept))
    if moe.n_shared:
        g = L.linear(xf, p["sh_gate"])
        u = L.linear(xf, p["sh_up"])
        y = y + L.linear(F.silu(g) * u, p["sh_down"])
    return y.reshape(B, S, D)
