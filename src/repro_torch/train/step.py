"""The training step: microbatched grad accumulation + AdamW (port of
``repro.train.step`` on one device).

``make_train_step`` builds a function

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

closed over the model and the step knobs.  Functional like the reference
and ``optim.adamw_update``: it returns new parameters and state and
leaves its inputs as they were.  With ``grad_accum`` n the batch's rows
are split into n microbatches, run in order; their losses and gradients
are summed (the gradients in ``accum_dtype``) and divided by n, as the
reference's scan does.  ``grad_compression="int8"`` passes the gradients
through the int8 round trip before the update.  The reference's sharding
helpers (``param_shardings``, ``opt_shardings``, ``batch_shardings``,
``shard_params``, ``jit_train_step``) are mesh code and wait for the
multi-GPU port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from ..models.model import Model
from ..parallel.compression import simulate_int8_roundtrip
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


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def loss_and_grads(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at ``params``, as
    ``jax.value_and_grad``: a parameter the loss does not read (the MoE
    FFN's norm) gets zeros."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), _unflatten_like(params, grads)


def make_train_step(model: Model, tc: TrainConfig = TrainConfig()
                    ) -> Callable:
    if tc.grad_compression not in COMPRESSIONS:
        raise ValueError(f"unknown grad_compression "
                         f"{tc.grad_compression!r}; one of {COMPRESSIONS}")

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if tc.grad_accum == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            n = tc.grad_accum
            rows = next(iter(batch.values())).shape[0]
            if rows % n:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {n} microbatches")
            m = rows // n
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=tc.accum_dtype, device=p.device), params)
            for k in range(n):
                mb = {name: x[k * m:(k + 1) * m]
                      for name, x in batch.items()}
                l, g = loss_and_grads(model, params, mb)
                loss = loss + l
                grads = tree_map(lambda a, b: a + b.to(tc.accum_dtype),
                                 grads, g)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)

        if tc.grad_compression == "int8":
            grads = tree_map(simulate_int8_roundtrip, grads)

        params2, opt2, metrics = adamw_update(tc.optimizer, params, grads,
                                              opt_state)
        metrics["loss"] = loss
        return params2, opt2, metrics

    return train_step
