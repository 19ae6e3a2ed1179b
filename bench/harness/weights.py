"""The cell's weights, made from the seed on the device in the dtype they
are served or trained in: one generator draw per parameter (each a stack
over the layers), so that any one can be drawn again alone, the same bits.

Distributions: the embedding N(0, ``embed_init_std``^2), each product's
weight N(0, 1 / fan_in), the products that end a residual branch (``wo``,
``w_down``) scaled further by ``residual_init_scale`` (GPT-2's 1 / sqrt(2
L), so that the residual stays near the embedding's scale through many
layers), each norm weight N(0, ``norm_init_std``^2) (not zero: a zero norm
weight would hide a program that scales by w instead of 1 + w).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layout(spec) -> Dict[str, Dict[str, Tuple[tuple, float]]]:
    """(shape, std) of every parameter, in the program's layout: groups
    ``pos0`` (each layer weight stacked over the layers), ``embed``,
    ``head`` (untied only) and ``final``."""
    D, V, L = spec.d_model, spec.vocab, spec.n_layers
    H, KV, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    ln = spec.norm_init_std
    pos = {"mix_ln": ((L, D), ln),
           "mix_wq": ((L, D, H * dh), D), "mix_wk": ((L, D, KV * dh), D),
           "mix_wv": ((L, D, KV * dh), D), "mix_wo": ((L, H * dh, D), H * dh),
           "ffn_ln": ((L, D), ln)}
    if spec.n_experts:
        E, Fe = spec.n_experts, spec.d_ff_expert
        pos.update({"ffn_router": ((L, D, E), D),
                    "ffn_w_gate": ((L, E, D, Fe), D),
                    "ffn_w_up": ((L, E, D, Fe), D),
                    "ffn_w_down": ((L, E, Fe, D), Fe)})
    else:
        F_ = spec.d_ff
        pos.update({"ffn_w_gate": ((L, D, F_), D),
                    "ffn_w_up": ((L, D, F_), D),
                    "ffn_w_down": ((L, F_, D), F_)})
    out = {"pos0": {k: (s, v if k.endswith("_ln") else 1 / math.sqrt(v)
                        * (spec.residual_init_scale
                           if k in ("mix_wo", "ffn_w_down") else 1.0))
                    for k, (s, v) in pos.items()},
           "embed": {"tok": ((V, D), spec.embed_init_std)}}
    if not spec.tie_embeddings:
        out["head"] = {"w": ((D, V), 1 / math.sqrt(D))}
    out["final"] = {"ln": ((D,), ln)}
    return out


def _seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(spec, seed: int, group: str, name: str, device,
         dtype=None) -> torch.Tensor:
    """Parameter ``group/name`` of the weights of ``seed``."""
    shape, std = layout(spec)[group][name]
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, f"{group}/{name}"))
    w = torch.randn(shape, generator=g, device=device,
                    dtype=DTYPES[spec.param_dtype])
    w.mul_(std)
    return w if dtype is None else w.to(dtype)


def make(spec, seed: int, device, dtype=None):
    """Every parameter of the weights of ``seed`` (in the parameter dtype,
    or ``dtype``)."""
    return {g: {n: draw(spec, seed, g, n, device, dtype) for n in sub}
            for g, sub in layout(spec).items()}
