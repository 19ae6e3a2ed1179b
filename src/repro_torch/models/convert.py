"""Carry parameter trees between the JAX package's layout and the port's.

``params_from_jax`` takes the JAX tree as numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the caller's side; this module
imports no JAX); ``params_to_jax`` gives one back, as the checkpoint
writes it (``train/checkpoint.py``: the parameters and both AdamW
moments).  Every shape is checked against the configuration, and the
3-D/4-D projection weights are reshaped between the JAX layout and the
port's 2-D one, so both packages compute the same function.  Block groups
are ``pos0``-``pos{period-1}``, each stacked over periods; the JAX shapes
are ``model.jax_axes_tree``'s (the SSM weights need no reshape).  The codebook
tables ``(ncb, V, D)`` and head ``(ncb, D, V)`` keep the JAX layout.  A
reshape moves no element, so a round trip returns the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .model import Params, jax_axes_tree, spec_tree


def _walk(tree: Mapping, cfg: ArchConfig):
    """(group, name, port shape, JAX shape, leaf) for every parameter of
    ``cfg``, after checking that ``tree`` has exactly its groups and
    names."""
    spec, jax = spec_tree(cfg), jax_axes_tree(cfg)
    if set(tree) != set(spec):
        raise ValueError(f"groups {sorted(tree)} != {sorted(spec)}")
    for g, sub in spec.items():
        if set(tree[g]) != set(sub):
            raise ValueError(f"{g}: {sorted(tree[g])} != {sorted(sub)}")
        for nm, (shape, _) in sub.items():
            yield g, nm, shape, jax[g][nm][0], tree[g][nm]


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: ArchConfig, device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    out: Params = {}
    for g, nm, shape, want, leaf in _walk(tree, cfg):
        a = np.asarray(leaf, np.float32)
        if a.shape != want:
            raise ValueError(f"{g}/{nm}: shape {a.shape} != {want}")
        out.setdefault(g, {})[nm] = torch.from_numpy(
            a.reshape(shape).copy()).to(dev)
    return out


def params_to_jax(params: Params, cfg: ArchConfig
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's tree (tensors on any device, or a tree of the same
    structure, such as an AdamW moment) as numpy arrays in the JAX
    layout, each on the host in its own dtype."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for g, nm, shape, want, t in _walk(params, cfg):
        if tuple(t.shape) != shape:
            raise ValueError(f"{g}/{nm}: shape {tuple(t.shape)} != "
                             f"{shape}")
        out.setdefault(g, {})[nm] = \
            t.detach().cpu().numpy().reshape(want)
    return out
