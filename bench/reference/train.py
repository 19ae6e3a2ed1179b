"""The reference's training steps: the loss's gradients by autograd over
the spec's family's ``reference.loss``, microbatches averaged, then AdamW
with global-norm clipping, the warmup-cosine schedule, bias correction and
decoupled weight decay, in place and in float32.  Parameters are held at
the values the configuration's parameter dtype can hold: each update is
rounded to it.

``steps`` returns what the check compares: each step's loss, each leaf's
first gradient as the optimizer takes it (after clipping), and each leaf's
change over the steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import shared as S

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaves(tree) -> Dict[str, torch.Tensor]:
    """A two-level parameter dict's leaves by ``group/name``."""
    return {f"{g}/{n}": t for g, sub in tree.items() for n, t in sub.items()}


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup"], 1), 1.0)
    t = min(max((step - opt["warmup"])
                / max(opt["decay_steps"] - opt["warmup"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


def grads(params, batch, spec, grad_accum: int, prec: S.Precision,
          rows=None):
    """(mean loss, gradient leaves) over the batch's microbatches.
    ``rows``: a fault's subset of each microbatch's rows (None: all)."""
    names = list(leaves(params))
    flat = [t.requires_grad_(True) for t in leaves(params).values()]
    total = None
    n_rows = batch["tokens"].shape[0]
    m = n_rows // grad_accum
    loss_sum = 0.0
    for i in range(grad_accum):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        if rows is not None:
            mb = {k: v[rows] for k, v in mb.items()}
        loss = spec.family.reference.loss(params, mb, spec, prec)
        g = torch.autograd.grad(loss, flat, allow_unused=True)
        g = [torch.zeros_like(t) if x is None else x.detach()
             for t, x in zip(flat, g)]
        total = g if total is None else [a + b for a, b in zip(total, g)]
        loss_sum += float(loss.detach())
    for t in flat:
        t.requires_grad_(False)
    return loss_sum / grad_accum, dict(zip(names, [t / grad_accum
                                                   for t in total]))


def steps(params, batches: List[dict], spec, opt: dict, grad_accum: int,
          prec: S.Precision = S.F32, rows=None):
    """Run len(batches) steps from ``params`` (f32 tensors, changed in
    place).  Returns {"loss": [...], "grad1": {leaf: norm}, "change":
    {leaf: norm}}."""
    held = DTYPES[spec.param_dtype]
    p = leaves(params)
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v_ = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "grad1": {}, "change": {}}
    for step, batch in enumerate(batches, start=1):
        loss, g = grads(params, batch, spec, grad_accum, prec, rows)
        out["loss"].append(loss)
        gnorm = math.sqrt(sum(float((x * x).sum()) for x in g.values()))
        scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
        lr = lr_at(opt, step)
        b1c = 1 - opt["b1"] ** step
        b2c = 1 - opt["b2"] ** step
        with torch.no_grad():
            for k, w in p.items():
                gk = g[k] * scale
                if step == 1:
                    out["grad1"][k] = float(gk.norm())
                m[k].mul_(opt["b1"]).add_(gk, alpha=1 - opt["b1"])
                v_[k].mul_(opt["b2"]).addcmul_(gk, gk, value=1 - opt["b2"])
                delta = (m[k] / b1c) / (torch.sqrt(v_[k] / b2c) + opt["eps"]) \
                    + opt["weight_decay"] * w
                w.sub_(lr * delta)
                w.copy_(w.to(held).float())
                del gk, delta
        del g
    for k, w in p.items():
        out["change"][k] = float((w - start[k]).norm())
    return out
