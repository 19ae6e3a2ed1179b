"""Carry parameters of the JAX package's ``init_params`` into the port.

The JAX tree is taken as numpy arrays (``jax.tree.map(np.asarray, tree)``
on the caller's side; this module imports no JAX).  Every shape is checked
against the configuration, and the 3-D/4-D projection weights are reshaped
to the port's 2-D layout, so both packages compute the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .model import Params, spec_tree


def _jax_shape(cfg: ArchConfig, name: str, shape: tuple) -> tuple:
    """The JAX shape of port parameter ``name`` (port shape ``shape``)."""
    P, D, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    if name == "mix_wq":
        return (P, D, cfg.n_heads, dh)
    if name in ("mix_wk", "mix_wv"):
        return (P, D, cfg.n_kv_heads, dh)
    if name == "mix_wo":
        return (P, cfg.n_heads, dh, D)
    return shape


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: ArchConfig, device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    spec = spec_tree(cfg)
    if set(tree) != set(spec):
        raise ValueError(f"groups {sorted(tree)} != {sorted(spec)}")
    out: Params = {}
    for g, sub in spec.items():
        if set(tree[g]) != set(sub):
            raise ValueError(f"{g}: {sorted(tree[g])} != {sorted(sub)}")
        for nm, (shape, _) in sub.items():
            a = np.asarray(tree[g][nm], np.float32)
            want = _jax_shape(cfg, nm, shape)
            if a.shape != want:
                raise ValueError(f"{g}/{nm}: shape {a.shape} != {want}")
            out.setdefault(g, {})[nm] = torch.from_numpy(
                a.reshape(shape).copy()).to(dev)
    return out
