"""Carry parameter trees between the JAX package's layout and the port's.

``params_from_jax`` takes the JAX tree as numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the caller's side; this module
imports no JAX); ``params_to_jax`` gives one back, as the checkpoint
writes it (``train/checkpoint.py``: the parameters and both AdamW
moments).  Every shape is checked against the configuration, and the
3-D/4-D projection weights are reshaped between the JAX layout and the
port's 2-D one, so both packages compute the same function.  Block groups
are ``pos0``-``pos{period-1}``, each stacked over periods; a position's
mixer kind decides its reshapes (the SSM weights need none).  The codebook
tables ``(ncb, V, D)`` and head ``(ncb, D, V)`` keep the JAX layout.  A
reshape moves no element, so a round trip returns the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .model import Params, spec_tree


def _jax_shape(cfg: ArchConfig, kind, name: str, shape: tuple) -> tuple:
    """The JAX shape of port parameter ``name`` (port shape ``shape``) at a
    position whose mixer is ``kind`` (None outside the block groups)."""
    P, D, dh, H = cfg.n_periods, cfg.d_model, cfg.head_dim, cfg.n_heads
    if kind == "mla":
        # MLA's (r, H, d) up-projections and (H, d_v, D) output; the port
        # keeps them 2-D, (r, H*d) and (H*d_v, D): the prefill expands K/V
        # with one product on the whole stack, and the absorbed decode
        # takes each head's (r, d) block as a strided view
        m = cfg.mla
        mla = {"mix_wq_b": (P, m.q_lora, H, m.d_nope + m.d_rope),
               "mix_wk_b": (P, m.kv_lora, H, m.d_nope),
               "mix_wv_b": (P, m.kv_lora, H, m.d_v),
               "mix_wo": (P, H, m.d_v, D)}
        return mla.get(name, shape)
    if kind == "attn":
        attn = {"mix_wq": (P, D, H, dh),
                "mix_wk": (P, D, cfg.n_kv_heads, dh),
                "mix_wv": (P, D, cfg.n_kv_heads, dh),
                "mix_wo": (P, H, dh, D)}
        return attn.get(name, shape)
    # the SSM kinds, the FFNs and the embedding, norm and head: as in JAX
    return shape


def _walk(tree: Mapping, cfg: ArchConfig):
    """(group, name, port shape, JAX shape, leaf) for every parameter of
    ``cfg``, after checking that ``tree`` has exactly its groups and
    names."""
    spec = spec_tree(cfg)
    if set(tree) != set(spec):
        raise ValueError(f"groups {sorted(tree)} != {sorted(spec)}")
    for g, sub in spec.items():
        kind = cfg.pattern[int(g[3:])] if g.startswith("pos") else None
        if set(tree[g]) != set(sub):
            raise ValueError(f"{g}: {sorted(tree[g])} != {sorted(sub)}")
        for nm, (shape, _) in sub.items():
            yield g, nm, shape, _jax_shape(cfg, kind, nm, shape), tree[g][nm]


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
