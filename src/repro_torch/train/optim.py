"""AdamW on nested dicts of tensors (port of ``repro.train.optim``).

The moments are f32 whatever the parameter dtype; the update has
global-norm clipping (the norm in f32), the warmup-cosine schedule, bias
correction and decoupled weight decay.  Plain tensor code, as the JAX
version is plain ``jnp``.  Functional like the JAX version: it returns new
parameters and state and leaves its inputs as they were.

The same code runs on the sharded step's DTensors: the update is
elementwise on each rank's shards, and each leaf's sum of squares in
``global_norm`` is a partial sum that DTensor reduces over the mesh, so the
norm is the global one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

Tree = Any   # a tensor, or a dict of trees


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.decay_steps - cfg.warmup,
                                              1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params: Tree) -> Dict[str, Tree]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum((l.float() ** 2).sum() for l in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: Dict[str, Tree]) -> Tuple[Tree, dict, dict]:
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def _pick(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
