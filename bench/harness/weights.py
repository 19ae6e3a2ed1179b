"""The cell's weights, made from the seed on the device in the dtype they
are served or trained in: one generator draw per parameter (each a stack
over the layers), so that any one can be drawn again alone, the same bits.
Each parameter's shape and std are its family's (``layout``; the
distributions are in the family's file).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layout(spec) -> Dict[str, Dict[str, Tuple[tuple, float]]]:
    """(shape, std) of every parameter by group and name, in the program's
    layout: the family's ``layout``."""
    return spec.family.layout(spec)


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
