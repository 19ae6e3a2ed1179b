"""Carry parameters of the JAX package's ``init_params`` into the port.

The JAX tree is taken as numpy arrays (``jax.tree.map(np.asarray, tree)``
on the caller's side; this module imports no JAX).  Every shape is checked
against the configuration, and the 3-D/4-D projection weights are reshaped
to the port's 2-D layout, so both packages compute the same function.
Block groups are ``pos0``-``pos{period-1}``, each stacked over periods; a
position's mixer kind decides its reshapes (the SSM weights need none).
The codebook tables ``(ncb, V, D)`` and head ``(ncb, D, V)`` keep the JAX
layout.
"""

from __future__ import annotations

from typing import Mapping

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


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: ArchConfig, device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    spec = spec_tree(cfg)
    if set(tree) != set(spec):
        raise ValueError(f"groups {sorted(tree)} != {sorted(spec)}")
    out: Params = {}
    for g, sub in spec.items():
        kind = cfg.pattern[int(g[3:])] if g.startswith("pos") else None
        if set(tree[g]) != set(sub):
            raise ValueError(f"{g}: {sorted(tree[g])} != {sorted(sub)}")
        for nm, (shape, _) in sub.items():
            a = np.asarray(tree[g][nm], np.float32)
            want = _jax_shape(cfg, kind, nm, shape)
            if a.shape != want:
                raise ValueError(f"{g}/{nm}: shape {a.shape} != {want}")
            out.setdefault(g, {})[nm] = torch.from_numpy(
                a.reshape(shape).copy()).to(dev)
    return out
