"""Pipeline parallelism over the 'pod' axis, GPipe-style (port of
``repro.parallel.pipeline``).

The layer stack (``n_periods`` of stacked params) is split into
``n_stages = |pod|`` contiguous stages; microbatches flow through the
stages with the boundary activations moved by a ring permute.  The
schedule is the classic (n_mb + n_stages - 1)-tick loop: stage s works on
microbatch (t - s) at tick t; the bubble fraction is (n_stages - 1) /
(n_mb + n_stages - 1).

Each rank holds the stage at its own ``pod`` coordinate.  Inside a stage
the activations are DTensors on the submesh ``mesh["data", "model"]`` and
run under the rules with ``pod`` stripped from every entry (the reference's
manual-over-'pod' ``shard_map`` with 'data'/'model' automatic), so the
regular sharded layer code runs unchanged.  The parameters come placed by
``pipeline_shardings``: the ``pos{i}`` stacks sharded over ``pod`` on
their periods dim, ``embed``/``final``/``head`` replicated over ``pod``.
A shared parameter's gradient is a partial sum over ``pod`` (a
``Partial`` placement, resolved when the caller redistributes it: the
reference's transpose of an ``in_specs`` of ``P()``, as
``parallel.sharding.region_grads`` states for ``manual``); a stage
stack's gradient is sharded over ``pod`` as its parameter is.

Bubble ticks: the reference computes on every tick and masks the bubble's
results; here a stage skips its bubble ticks and passes its input through
unchanged, which changes no value.  The pass-through keeps every tick's
permute on the autograd path of every rank, so that each rank runs the
permutes' backward (the reverse permutation) in the same order as its
ring neighbours: stage 0 joins the buffer it receives to its embedding
with a zero gradient (``_First``), and the loss carries a zero-gradient
edge to the last tick's activation (``_PodSum``).

Embedding runs on stage 0, final norm + head + loss on the last stage; the
loss of the valid ticks is summed over ``pod`` (forward only: its
backward is the identity, since each rank's loss term enters the sum once)
and divided by ``n_mb``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial

from ..models import layers as L
from ..models.model import Model
from ..train.data import batch_axes, make_global_batch
from ..train.step import _split, batch_shardings, param_shardings
from .sharding import (MeshShape, NamedSharding, P, ShardingRules,
                       axis_rules, distribute, mesh_sizes)

SHARED = ("embed", "final", "head")


def _split_stages(stacked: Dict[str, torch.Tensor], n_stages: int):
    """(P_, ...) stacked period params -> (n_stages, P_/n_stages, ...)."""
    def one(a):
        p = a.shape[0]
        assert p % n_stages == 0, (p, n_stages)
        return a.reshape((n_stages, p // n_stages) + tuple(a.shape[1:]))
    return {k: one(v) for k, v in stacked.items()}


def _n_stages(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        raise ValueError(f"the pipeline runs over a 'pod' mesh axis; the "
                         f"mesh has {names}")
    return mesh.shape[names.index("pod")]


def stage_rules(rules: ShardingRules) -> ShardingRules:
    """The rules inside a stage: ``pod`` stripped from every entry, on the
    submesh of the other axes (``mesh["data", "model"]``)."""
    table = {}
    for k, v in rules.table.items():
        axes = (v,) if isinstance(v, str) else tuple(v or ())
        axes = tuple(a for a in axes if a != "pod")
        table[k] = axes if axes else None
    mesh = rules.mesh
    rest = tuple(a for a in mesh.mesh_dim_names if a != "pod")
    if isinstance(mesh, MeshShape):
        sub = MeshShape(rest, tuple(mesh_sizes(mesh)[a] for a in rest))
    else:
        sub = mesh[rest]
    return ShardingRules(rules.name + "-pipe", table, sub)


def pipeline_shardings(model: Model, rules: ShardingRules):
    """NamedSharding tree of the parameters on the full mesh: each weight's
    spec under the stripped rules, and the ``pos{i}`` stacks' periods dim
    over ``pod``."""
    table = {k: v for k, v in stage_rules(rules).table.items()}
    flat = ShardingRules(rules.name, table, rules.mesh)
    out = param_shardings(model, flat)
    for g, sub in out.items():
        if g not in SHARED:
            out[g] = {k: NamedSharding(rules.mesh, P("pod", *tuple(
                s.spec)[1:])) for k, s in sub.items()}
    return out


def place_pipeline(model: Model, params, rules: ShardingRules):
    """A parameter tree that every rank holds whole, placed by
    ``pipeline_shardings`` (each rank keeps its slice)."""
    sh = pipeline_shardings(model, rules)
    return {g: {k: distribute(v, sh[g][k]) for k, v in sub.items()}
            for g, sub in params.items()}


def _on_submesh(w: DTensor, sub, shared: bool) -> DTensor:
    """``w`` (on the full mesh, pod first) as a DTensor on the stage's
    submesh: the rank's block, with the other mesh dims' placements.  A
    shared weight's gradient comes back as a partial sum over ``pod``."""
    grad_pl = ((Partial(),) + tuple(w.placements[1:])) if shared else None
    local = w.to_local(grad_placements=grad_pl)
    return DTensor.from_local(local, sub, tuple(w.placements[1:]),
                              run_check=False)


def _exchange(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    """Each rank's local tensor to the next stage, (s + 1) % n, and the
    previous stage's in its place; the backward is the reverse
    permutation.  ``anchors`` (the rank's weights, no gradient through
    here) put every permute on the path to every weight, so that
    ``torch.autograd.grad`` prunes none of them on any rank: a stage's
    first buffer leads to no weight of its own."""

    @staticmethod
    def forward(ctx, x, group, to, frm, *anchors):
        ctx.group, ctx.to, ctx.frm, ctx.n = group, to, frm, len(anchors)
        return _exchange(x, to, frm, group)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.frm, ctx.to, ctx.group), None, None, None,
                *(None,) * ctx.n)


def _permute(x: DTensor, group, to: int, frm: int, anchors) -> DTensor:
    out = _Permute.apply(x.to_local(), group, to, frm, *anchors)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)


class _First(torch.autograd.Function):
    """``a``, with ``b`` on the autograd path at a zero gradient."""

    @staticmethod
    def forward(ctx, a, b):
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _PodSum(torch.autograd.Function):
    """The loss summed over ``pod``; its backward is the identity (each
    rank's term enters the sum once), with zero gradients to ``anchors``:
    the last tick's activation, which keeps every rank's permutes on the
    backward's path, and the shared weights, so that each has a gradient
    on every stage, those that do not read it too."""

    @staticmethod
    def forward(ctx, acc, group, *anchors):
        ctx.anchors = [(a.shape, a.dtype, a.device) for a in anchors]
        out = acc.clone()
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g, None, *(torch.zeros(shape, dtype=dtype, device=device)
                           for shape, dtype, device in ctx.anchors))


def _mb_input_shape(model: Model, mb) -> tuple:
    tok = mb["tokens"]
    seq = tok.shape[1] + (mb["patches"].shape[1] if "patches" in mb else 0)
    return (tok.shape[0], seq, model.cfg.d_model)


def pipeline_loss(model: Model, rules: ShardingRules, params, batch, *,
                  n_mb: int = 4):
    """Cross-entropy loss with the layer stack pipelined over 'pod'.

    ``params`` are placed by ``pipeline_shardings`` (``place_pipeline``);
    ``batch`` is the global host batch, the same on every rank.  Equal to
    ``model.loss`` up to rounding when ``n_periods % |pod| == 0`` and the
    batch's rows split into ``n_mb`` microbatches; returns a plain scalar
    tensor, the same on every rank."""
    mesh = rules.mesh
    n_stages = _n_stages(mesh)
    cfg = model.cfg
    if cfg.n_periods % n_stages:
        raise ValueError(f"{cfg.n_periods} periods do not split into "
                         f"{n_stages} stages")
    per = cfg.n_periods // n_stages
    srules = stage_rules(rules)
    sub = srules.mesh
    s = mesh.get_local_rank("pod")
    last = n_stages - 1
    group: Optional[object] = None
    to = frm = None
    if n_stages > 1:
        group = mesh.get_group("pod")
        ranks = dist.get_process_group_ranks(group)
        to, frm = ranks[(s + 1) % n_stages], ranks[(s - 1) % n_stages]

    stage = {f"pos{i}": {k: _on_submesh(v, sub, False)
                         for k, v in params[f"pos{i}"].items()}
             for i in range(cfg.period)}
    shared = {g: {k: _on_submesh(v, sub, True) for k, v in params[g].items()}
              for g in SHARED if g in params}
    axes = batch_axes(cfg)
    mbs: List[dict] = []
    for mb in _split(batch, n_mb):
        specs = {k: (tuple(v.shape), axes[k]) for k, v in mb.items()}
        mbs.append(make_global_batch(mb, batch_shardings(srules, specs)))

    weights = [w.to_local() for tree in (stage, shared)
               for sub_ in tree.values() for w in sub_.values()]
    n_ticks = n_mb + n_stages - 1
    loss_acc = torch.zeros((), dtype=torch.float32, device=sub.device_type)
    buf = x = None
    with axis_rules(srules):
        for t in range(n_ticks):
            active = 0 <= t - s < n_mb
            if s == 0 and active:
                x = model._embed(shared, mbs[t])
                if buf is not None:
                    x = _First.apply(x, buf)
            elif buf is not None:
                x = buf
            else:   # a later stage's first tick: a bubble, nothing received
                shape = _mb_input_shape(model, mbs[0])
                spec = srules.spec("batch", "seq", "embed", dims=shape)
                x = distribute(torch.zeros(shape, dtype=(
                    model.knobs.compute_dtype)), NamedSharding(sub, spec))
            if active:
                x = model._periods(stage, x, per)
            if s == last and active:
                h = L.rms_norm(x, shared["final"]["ln"], cfg.norm_eps)
                ce = model._ce(model._head(shared, h),
                               mbs[t - last]["labels"])
                if isinstance(ce, DTensor):
                    ce = ce.full_tensor()
                loss_acc = loss_acc + ce
            if t < n_ticks - 1 and group is not None:
                buf = _permute(x, group, to, frm, weights)
    anchors = [t.to_local() for t in [x] + [w for sub_ in shared.values()
                                            for w in sub_.values()]]
    return _PodSum.apply(loss_acc, group, *anchors) / n_mb
