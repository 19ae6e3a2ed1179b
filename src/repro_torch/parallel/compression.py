"""Blockwise int8 gradient compression (port of the elementwise part of
``repro.parallel.compression``).

``simulate_int8_roundtrip`` quantizes a tensor to int8 blocks of
``BLOCK`` elements with an f32 scale each and dequantizes it: what a
compressed wire format loses, applied to already-reduced gradients by the
train step's ``grad_compression="int8"``.  Plain tensor code, as the
reference's is plain ``jnp``; the same rounding (half to even) and clip,
so both give the same bits.  The reference's compressed ring all-reduce
(``ring_allreduce_int8``) and ``ErrorFeedback`` wait for the multi-GPU
port.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def _pad_to(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    pad = (-n) % m
    if pad:
        x = torch.cat([x.reshape(-1), x.new_zeros(pad)])
    return x.reshape(-1), pad


def quantize_int8(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (q int8 (nb, BLOCK), scales f32 (nb,), pad)."""
    flat, pad = _pad_to(x.float(), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return q, scale, pad


def dequantize_int8(q, scale, pad, shape, dtype):
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def simulate_int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 0:
        return x
    q, s, pad = quantize_int8(x)
    return dequantize_int8(q, s, pad, x.shape, x.dtype)
