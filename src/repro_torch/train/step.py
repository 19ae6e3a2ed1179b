"""The training step: microbatched grad accumulation + AdamW (port of
``repro.train.step``).

``make_train_step`` builds a function

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

closed over the model, the step knobs and, for a sharded step, the
sharding rules.  Functional like the reference and ``optim.adamw_update``:
it returns new parameters and state and leaves its inputs as they were.
With ``grad_accum`` n the batch's rows are split into n microbatches, run
in order; their losses and gradients are summed (the gradients in
``accum_dtype``) and divided by n, as the reference's scan does.
``grad_compression="int8"`` passes the gradients through the int8 round
trip before the update (sharded: each gradient whole, as the reference's
blocks run over the logical array).

Sharded (``rules`` with a mesh): the parameters and AdamW state are
DTensors placed by ``param_shardings`` / ``opt_shardings`` (``shard_params``
places a tree that every rank holds whole), and ``batch`` is the global
host batch, the same on every rank.  The step splits it into microbatches
first and places each one (``train/data.py`` ``make_global_batch``: each
rank keeps its slice), runs the loss under the rules, and redistributes
every gradient to its parameter's placements inside the microbatch loop
(``constrain_grads``, as the reference's ``acc_body``).  Its metrics are
plain tensors, the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..models.model import Model, spec_tree
from ..parallel.compression import simulate_int8_roundtrip
from ..parallel.sharding import (NamedSharding, P, ShardingRules, axis_rules,
                                 distribute, gather, map_axes, merge_spec,
                                 place)
from .data import batch_axes, make_global_batch
from .optim import AdamWConfig, adamw_update, tree_leaves, tree_map

COMPRESSIONS = ("none", "int8")


@dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    # 'none' | 'int8' -- the gradients' int8 round trip
    grad_compression: str = "none"
    # grad accumulation dtype (f32 default; bf16 halves the carry)
    accum_dtype: torch.dtype = torch.float32


# ---------------------------------------------------------------------------
# placement trees
# ---------------------------------------------------------------------------

def param_shardings(model: Model, rules: ShardingRules):
    """NamedSharding tree for params (and f32 moments) under the rules: each
    spec computed on the weight's JAX shape (``Model.param_shapes``, the
    shape its logical axes describe) and mapped onto the port's shape
    (``merge_spec``)."""
    port = spec_tree(model.cfg)

    def one(ax, shp, own):
        spec = rules.spec(*ax, dims=shp)
        return NamedSharding(rules.mesh, merge_spec(spec, shp, own[0]))
    return map_axes(one, model.param_axes(), model.param_shapes(), port)


def opt_shardings(model: Model, rules: ShardingRules):
    ps = param_shardings(model, rules)
    return {"m": ps, "v": ps, "step": NamedSharding(rules.mesh, P())}


def batch_shardings(rules: ShardingRules, batch_specs):
    """batch_specs: dict name -> (shape, logical axes)."""
    return {k: NamedSharding(rules.mesh, rules.spec(*ax, dims=shape))
            for k, (shape, ax) in batch_specs.items()}


def shard_params(model: Model, params, rules: ShardingRules):
    """Place an (unsharded) param tree onto the mesh."""
    return place(params, param_shardings(model, rules))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def loss_and_grads(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at ``params``, as
    ``jax.value_and_grad``: a parameter the loss does not read (the MoE
    FFN's norm) gets zeros.  A DTensor loss is made whole (replicated)
    before the backward."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(_unflatten_like(params, leaves), batch)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), _unflatten_like(params, grads)


def _split(batch: Dict[str, torch.Tensor], n: int):
    """The batch's rows in n microbatches (views)."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} "
                         f"microbatches")
    m = rows // n
    return [{name: x[k * m:(k + 1) * m] for name, x in batch.items()}
            for k in range(n)]


def make_train_step(model: Model, tc: TrainConfig = TrainConfig(), *,
                    rules: Optional[ShardingRules] = None) -> Callable:
    if tc.grad_compression not in COMPRESSIONS:
        raise ValueError(f"unknown grad_compression "
                         f"{tc.grad_compression!r}; one of {COMPRESSIONS}")
    sharded = rules is not None and rules.mesh is not None
    if sharded:
        p_shard = param_shardings(model, rules)
        axes = batch_axes(model.cfg)

    def constrain_grads(g):
        """Each gradient leaf redistributed to its parameter's placements
        (the reference pins them so that the accumulation carry is not left
        to propagation)."""
        if not sharded:
            return g
        return tree_map(lambda leaf, s: leaf.redistribute(
            s.mesh, s.placements), g, p_shard)

    def grads_of(params, mb):
        if not sharded:
            return loss_and_grads(model, params, mb)
        specs = {k: (tuple(v.shape), axes[k]) for k, v in mb.items()}
        mb = make_global_batch(mb, batch_shardings(rules, specs))
        with axis_rules(rules):
            loss, g = loss_and_grads(model, params, mb)
        return loss, constrain_grads(g)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if tc.grad_accum == 1:
            loss, grads = grads_of(params, batch)
        else:
            n = tc.grad_accum
            mbs = _split(batch, n)
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            grads = constrain_grads(tree_map(lambda p: torch.zeros_like(
                p, dtype=tc.accum_dtype), params))
            for mb in mbs:
                l, g = grads_of(params, mb)
                loss = loss + l
                grads = constrain_grads(tree_map(
                    lambda a, b: a + b.to(tc.accum_dtype), grads, g))
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)

        if tc.grad_compression == "int8" and sharded:
            # the reference's blocks run over the whole (logical) array
            grads = tree_map(lambda g, s: distribute(
                simulate_int8_roundtrip(g.full_tensor()), s), grads, p_shard)
        elif tc.grad_compression == "int8":
            grads = tree_map(simulate_int8_roundtrip, grads)

        params2, opt2, metrics = adamw_update(tc.optimizer, params, grads,
                                              opt_state)
        metrics["loss"] = loss
        if sharded:
            metrics = gather(metrics)
        return params2, opt2, metrics

    return train_step


def placed_train_step(model: Model, rules: ShardingRules, tc: TrainConfig):
    """The analogue of the reference's ``jit_train_step``: the step with its
    outputs redistributed to (param placements, opt placements, replicated
    metrics).  Its inputs are placed by ``shard_params`` (and
    ``place(opt, opt_shardings(...))``) and the batch by the step itself."""
    step = make_train_step(model, tc, rules=rules)
    os_ = opt_shardings(model, rules)

    def redistribute(tree, shardings):
        if isinstance(tree, dict):
            return {k: redistribute(v, shardings[k]) for k, v in tree.items()}
        return tree.redistribute(shardings.mesh, shardings.placements)

    def run(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        return (redistribute(params, os_["m"]),
                redistribute(opt_state, os_), metrics)
    return run
