"""Mixture-of-experts FFN (port of ``repro.models.moe``): expert-parallel
dispatch on a mesh, sort-based capacity dispatch, the dense decoy, and
shared experts.

The dispatch is a tuning knob of the step (``ModelKnobs.moe_dispatch``,
``StepKnobs.moe_dispatch`` in ``tune/lm_study.py``):

- ``a2a`` (the default): the reference's expert parallelism
  (``_ep_dispatch``) under active sharding rules with a mesh, one of three
  regimes picked from the rules exactly as the reference picks it:
    * tokens sharded over the expert axis -> all_to_all dispatch (tokens
      travel to their experts' rank and back; cp);
    * tokens replicated over the expert axis -> each rank runs its own
      experts on every token and the outputs are summed (tp);
    * experts unsharded -> the local sort dispatch per token shard (dp).
  Capacity is per token shard (``_capacity``), so which tokens share a
  rank is part of the result.  With no mesh, ``a2a`` is ``sort``, which is
  all a single device runs;
- ``sort``: argsort the token-expert pairs by expert, pack each expert's
  first ``cap`` tokens into an ``(E, cap, D)`` buffer, run every expert on
  its rows and gather the outputs back.  Pairs beyond an expert's capacity
  are dropped, as in JAX.  Under rules it is the global program on the
  gathered tokens, as the reference's SPMD program replicates its
  data-dependent gather and scatter (its naive baseline arm), with the
  expert products split as its ``expert``/``exp_cap`` annotations say
  (``expert_rule``);
- ``dense``: every expert on every token, combined by the gate matrix
  (tiny configurations only); under rules the global program on every
  rank.

Every product goes through ``ops.matmul``: the router, and three launches
per expert (gate, up, down), so 3E expert launches a layer whatever the
dispatch and the regime (under tp each rank runs its E / n experts; the
reference's extra expert of zero weights, which takes the pairs routed to
other ranks, is not run: its rows are zero times a zero gate).  Argsort,
the counts, cumsum and the index writes are plain tensor code, as they are
plain ``jnp`` in JAX.  Two choices keep the card's result a fixed function
of its inputs: the argsort is stable (as ``jnp.argsort`` is), so the card
drops the same pairs as JAX; and the combine un-permutes the pairs and
sums each token's ``k`` contributions in index order, where JAX
scatter-adds (``index_add_`` on CUDA adds by atomics in no fixed order).

On a mesh the regimes run each rank's local tensors through
``parallel.sharding.on_shards`` (``local_map``) under a rule that states,
mesh dim by mesh dim, where each input lies and how its gradient sums
(``_ep_rule``); the all_to_all is ``all_to_all_single_autograd`` on the
expert mesh dim's group, whose rank order is the mesh coordinate (the
reference's ``axis_index``).

As in the reference, the FFN's ``ln`` weight is not read: the router and
the experts see the un-normalized residual.

Spans and counters (``obs.py``; recorded only while a profiler session
records): ``model.moe_ffn`` around ``moe_ffn``, with device times; in the
sort dispatch on one device (``_sort_dispatch``) ``moe.pairs`` (T x k, the
routed pairs), ``moe.rows`` (E x cap, the rows the experts compute) and
``moe.kept`` (the pairs within their expert's capacity, summed on the
device), each under the phase span that holds the call (an engine prefill
or decode step, a train step).  Records are per thread: remat's recompute
counts a second time under the train step where autograd runs the backward
in the calling thread (the CPU), and in autograd's own thread, apart, on a
card.  The dense and the sharded dispatches are not counted.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import obs
from ..kernels import ops
from ..parallel.sharding import (annotate, current_rules, mesh_sizes,
                                 on_shards, placements, reshape)
from . import layers as L

DISPATCHES = ("a2a", "sort", "dense")
_R = Replicate()


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


def _expert_ffn_local(p, x):
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


def expert_rule(x, wg, wu, wd):
    """Placements for the expert products, x (E, C, D) against the stacks
    (E, D, F) / (E, F, D), mesh dim by mesh dim: x's experts split evenly
    keep the stacks split with them (each rank runs its experts); x's rows
    split keep the stacks gathered, whose gradients are then partial sums;
    anything else is gathered.  The output and x's gradient have x's
    placements (the reference annotates the products ``expert``,
    ``exp_cap``, ``ffn``, with ``ffn`` on an axis ``expert`` holds)."""
    in_x, in_w, g_w = [], [], []
    mesh = x.device_mesh
    for i, px in enumerate(x.placements):
        n = mesh.size(i)
        if px.is_shard(0) and x.shape[0] % n == 0:
            got = (px, px, px)
        elif px.is_shard(1) and x.shape[1] % n == 0:
            got = (px, _R, Partial())
        else:
            got = (_R, _R, _R)
        for lst, p in zip((in_x, in_w, g_w), got):
            lst.append(p)
    in_x, in_w, g_w = tuple(in_x), tuple(in_w), tuple(g_w)
    return (in_x, in_w, in_w, in_w), in_x, (in_x, g_w, g_w, g_w)


def _expert_ffn(p, x):
    """``_expert_ffn_local`` (on a rank's local tensors too); on DTensors
    under ``expert_rule``."""
    stacks = (p["w_gate"], p["w_up"], p["w_down"])
    if not ops.is_distributed(x, *stacks):
        return _expert_ffn_local(p, x)
    return on_shards(lambda x_, g_, u_, d_: _expert_ffn_local(
        {"w_gate": g_, "w_up": u_, "w_down": d_}, x_), expert_rule, x,
        *stacks)


# ---------------------------------------------------------------------------
# the capacity dispatch: plan, pack, combine
# ---------------------------------------------------------------------------

def _capacity(t_loc: int, k: int, n_exp: int, cf: float) -> int:
    """Rows per expert of a token shard of ``t_loc`` tokens (the expert
    parallel dispatch): ceil, rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(t_loc * k / n_exp * cf))
    return max(8 * ((c + 7) // 8), 8)


def _plan(idx, n_exp: int, cap: int):
    """(order, slot, keep) of the (T, k) token-expert pairs: the pairs
    sorted by expert (stable), each sorted pair's row ``expert * cap +
    position`` of the packed buffer, and whether it is within its expert's
    capacity."""
    tk = idx.numel()
    fidx = idx.reshape(tk)
    order = torch.argsort(fidx, stable=True)
    se = fidx[order]
    # position within expert: running index minus the expert's start (the
    # counts by a scatter, whose shape does not depend on the indices, as
    # bincount's does: the dry-run traces this on fake tensors)
    counts = torch.zeros(n_exp, dtype=fidx.dtype, device=fidx.device) \
        .scatter_add_(0, fidx, torch.ones_like(fidx))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=idx.device) - starts[se]
    return order, se * cap + pos, pos < cap


def _local_pack(x, idx, plan, n_exp: int, cap: int):
    """The tokens x (T, D) sorted into an (n_exp, cap, D) buffer by
    ``plan``.  Dropped pairs land in one extra row, cut off before the
    experts (a mask would sync the host with the device)."""
    order, slot, keep = plan
    k = idx.shape[-1]
    buf = x.new_zeros(n_exp * cap + 1, x.shape[-1]).index_put(
        (torch.where(keep, slot, n_exp * cap),), x[order // k])
    return buf[:-1].view(n_exp, cap, x.shape[-1])


def _local_combine(y_slots, gates, idx, plan):
    """The inverse of ``_local_pack``: (y (T, D), kept (T, k)).  Each pair
    takes its slot's output times its gate (zero where dropped); the pairs
    are un-permuted and each token's k contributions summed in index
    order."""
    order, slot, keep = plan
    T, k = idx.shape
    D = y_slots.shape[-1]
    sg = gates.reshape(T * k)[order]
    y_sorted = y_slots.reshape(-1, D)[torch.where(keep, slot, 0)] \
        * (keep * sg).to(y_slots.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    y_pairs = y_sorted[inv].view(T, k, D)
    y = y_pairs[:, 0]
    for j in range(1, k):
        y = y + y_pairs[:, j]
    return y, keep[inv].view(T, k)


def _sort_dispatch(p, xf, gates, idx, moe):
    """(y (T, D), kept (T, k) bool): the capacity dispatch on one
    device."""
    E = moe.n_experts
    cap = sort_capacity(idx.numel(), E, moe.capacity_factor)
    plan = _plan(idx, E, cap)
    obs.count("moe.pairs", idx.numel())
    obs.count("moe.rows", E * cap)
    obs.count("moe.kept", plan[2])
    ye = _expert_ffn(p, _local_pack(xf, idx, plan, E, cap))
    return _local_combine(ye, gates, idx, plan)


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


def _route(xf, router, moe):
    gates, idx = router_topk(L.linear(xf, router).float(), moe.top_k)
    return gates.to(xf.dtype), idx


# ---------------------------------------------------------------------------
# under rules: the global programs and the expert-parallel dispatch
# ---------------------------------------------------------------------------

def _replicated_rule(*tensors):
    """Every input gathered, every rank runs the global program: the
    output and every gradient replicated (each rank's is whole)."""
    rep = (_R,) * tensors[0].device_mesh.ndim
    return (rep,) * len(tensors), rep, (rep,) * len(tensors)


def _global_dispatch(p, xf, moe, dispatch, routing):
    """``sort`` or ``dense`` under rules: the router on the token shards,
    then the global program on the gathered tokens (sort: its pack and
    combine; dense: all of it) with sort's expert products split by the
    ``expert``/``exp_cap`` annotations."""
    E, k = moe.n_experts, moe.top_k
    logits = L.linear(xf, p["router"])
    stacks = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
    if dispatch == "dense":
        def dense(x_, l_, g_, u_, d_):
            gates, idx = router_topk(l_.float(), k)
            y, kept = _dense_dispatch({"w_gate": g_, "w_up": u_,
                                       "w_down": d_}, x_,
                                      gates.to(x_.dtype), idx, moe)
            if routing is not None:
                routing.append((idx, kept))
            return y
        return on_shards(dense, _replicated_rule, xf, logits,
                         *stacks.values())
    cap = sort_capacity(xf.shape[0] * k, E, moe.capacity_factor)

    def pack(x_, l_):
        idx = router_topk(l_.float(), k)[1]
        return _local_pack(x_, idx, _plan(idx, E, cap), E, cap)

    def combine(y_, l_):
        gates, idx = router_topk(l_.float(), k)
        y, kept = _local_combine(y_, gates.to(y_.dtype), idx,
                                 _plan(idx, E, cap))
        if routing is not None:
            routing.append((idx, kept))
        return y
    he = annotate(on_shards(pack, _replicated_rule, xf, logits), "expert",
                  "exp_cap", "embed")
    ye = annotate(_expert_ffn(stacks, he), "expert", "exp_cap", "embed")
    return on_shards(combine, _replicated_rule, ye, logits)


def _axes_tuple(v):
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def _ep_dispatch(p, xf, moe, rules, routing=None):
    """The expert-parallel dispatch (the module docstring's regimes) on the
    tokens ``xf`` (T, D), placed by the ``tokens`` spec."""
    mesh = rules.mesh
    T, D = xf.shape
    E, k, cf = moe.n_experts, moe.top_k, moe.capacity_factor
    tok_spec = rules.spec("tokens", None, dims=(T, D))
    tok_axes = _axes_tuple(tok_spec[0] if len(tok_spec) else None)
    w_spec = rules.spec("expert", "fsdp_embed", "ffn",
                        dims=p["w_gate"].shape)
    exp_axes = _axes_tuple(w_spec[0] if len(w_spec) else None)
    assert len(exp_axes) <= 1, exp_axes
    exp_ax = exp_axes[0] if exp_axes else None
    n_ep = mesh_sizes(mesh)[exp_ax] if exp_ax else 1
    e_loc = E // n_ep
    t_loc = T
    for ax in tok_axes:
        t_loc //= mesh_sizes(mesh)[ax]
    cap = _capacity(t_loc, k, E, cf)
    tp = exp_ax is not None and exp_ax not in tok_axes
    names = tuple(mesh.mesh_dim_names)
    tok_dims = {names.index(a) for a in tok_axes}
    e_dim = names.index(exp_ax) if exp_ax else None

    def _ep_rule(*_):
        """The tokens on their spec; the router gathered; each expert stack
        split on the expert mesh dim only (the reference's
        ``_gather_weight``: ``redistribute_inputs`` all-gathers its FSDP
        shards, and its backward reduce-scatters).  Under tp each rank's
        output covers its experts only: a ``Partial`` sum on the expert
        mesh dim, as is x's gradient there.  The router's gradient sums
        over the mesh dims that split the tokens (and, under tp, over the
        expert dim: only a rank's own experts' gates pass a gradient); an
        expert stack's over the token dims but the expert one."""
        x_in = placements(tok_spec, mesh)
        rep = (_R,) * len(names)
        w_in = tuple(Shard(0) if i == e_dim else _R
                     for i in range(len(names)))
        x_out = tuple(Partial() if tp and i == e_dim else x_in[i]
                      for i in range(len(names)))
        g_r = tuple(Partial() if i in tok_dims or (tp and i == e_dim)
                    else _R for i in range(len(names)))
        g_w = tuple(Shard(0) if i == e_dim else Partial()
                    if i in tok_dims else _R for i in range(len(names)))
        return ((x_in, rep, w_in, w_in, w_in), x_out,
                (x_out, g_r, g_w, g_w, g_w))

    def body(xl, router, wg, wu, wd):
        stacks = {"w_gate": wg, "w_up": wu, "w_down": wd}
        gates, idx = _route(xl, router, moe)
        if exp_ax is None:
            # experts fully local
            plan = _plan(idx, E, cap)
            ye = _expert_ffn(stacks, _local_pack(xl, idx, plan, E, cap))
            y, kept = _local_combine(ye, gates, idx, plan)
        elif not tp:
            # all_to_all: tokens travel to their experts' rank and back
            group = mesh.get_group(exp_ax)
            plan = _plan(idx, E, cap)
            send = _local_pack(xl, idx, plan, E, cap)
            recv = _all_to_all(send.reshape(E * cap, D), group)
            he = recv.view(n_ep, e_loc, cap, D).transpose(0, 1) \
                .reshape(e_loc, n_ep * cap, D)
            ye = _expert_ffn(stacks, he)
            back = ye.view(e_loc, n_ep, cap, D).transpose(0, 1) \
                .reshape(E * cap, D)
            ret = _all_to_all(back, group)
            y, kept = _local_combine(ret.view(E, cap, D), gates, idx, plan)
        else:
            # tokens replicated over the expert axis: this rank's experts
            # on every token, the other pairs to an overflow expert whose
            # rows are zero; the outputs sum over the expert axis
            lo = mesh.get_local_rank(exp_ax) * e_loc
            local = (idx >= lo) & (idx < lo + e_loc)
            idx_l = torch.where(local, idx - lo, e_loc)
            gates_l = torch.where(local, gates, 0.0).to(xl.dtype)
            cap_l = _capacity(xl.shape[0], k, e_loc, cf)
            plan = _plan(idx_l, e_loc + 1, cap_l)
            buf = _local_pack(xl, idx_l, plan, e_loc + 1, cap_l)
            ye = _expert_ffn(stacks, buf[:e_loc])
            ye = torch.cat([ye, ye.new_zeros(1, cap_l, D)])
            y, kept = _local_combine(ye, gates_l, idx_l, plan)
            kept = kept & local
        if routing is not None:
            routing.append((idx, kept))
        return y

    return on_shards(body, _ep_rule, xf, p["router"].to(xf.dtype),
                     p["w_gate"], p["w_up"], p["w_down"])


def _all_to_all(t, group):
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over
    ``group``: t's rows in equal chunks, chunk i to the group's rank i, the
    received chunks stacked in rank order (differentiable)."""
    return funcol.wait_tensor(
        funcol.all_to_all_single_autograd(t, None, None, group))


def moe_ffn(p, x, cfg, *, dispatch: str = "a2a",
            routing: Optional[List] = None):
    """x: (B, S, D) -> (B, S, D).  p holds router (D, E), expert stacks
    (E, D, F)/(E, F, D), and the shared experts' 2-D weights where
    ``cfg.moe.n_shared``.  ``routing``: a list to which the layer appends
    ``(idx (T, k), kept (T, k))``, the experts chosen per token and which
    of those pairs were computed (all of them under ``dense``); under the
    expert-parallel dispatch each rank's own tokens, and under its tp
    regime the pairs computed on this rank.

    With a DTensor x under active rules with a mesh, the tokens are
    flattened to the reference's ``tokens`` spec first (each rank a
    contiguous block of the flat index, in mesh order)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {dispatch!r}")
    with obs.span("model.moe_ffn", device=True):
        return _moe_ffn(p, x, cfg, dispatch, routing)


def _moe_ffn(p, x, cfg, dispatch, routing):
    moe = cfg.moe
    B, S, D = x.shape
    rules = current_rules()
    xf = annotate(reshape(x, (B * S, D)), "tokens", "embed")
    if isinstance(xf, DTensor) and rules is not None \
            and rules.mesh is not None:
        if dispatch == "a2a":
            y = _ep_dispatch(p, xf, moe, rules, routing)
        else:
            y = _global_dispatch(p, xf, moe, dispatch, routing)
        y = annotate(y, "tokens", "embed")
    else:
        gates, idx = _route(xf, p["router"], moe)
        if dispatch == "dense":
            y, kept = _dense_dispatch(p, xf, gates, idx, moe)
        else:                   # "a2a" with no mesh is "sort"
            y, kept = _sort_dispatch(p, xf, gates, idx, moe)
        if routing is not None:
            routing.append((idx, kept))
    if moe.n_shared:
        g = L.linear(xf, p["sh_gate"])
        u = L.linear(xf, p["sh_up"])
        y = y + L.linear(F.silu(g) * u, p["sh_down"])
    y = annotate(y, "tokens", "embed")
    return reshape(y, (B, S, D))
