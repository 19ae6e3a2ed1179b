"""Causal GQA flash attention on the card: wrapper of
``csrc/flash_attention.cu``.

Port of ``repro.kernels.flash_attention`` (Pallas ``_flash_kernel``).  The
plain version is ``ref.flash_attention_ref``; ``ops.flash_attention`` picks
between the two by the tensors' device.  The wrapper takes the model-native
``(B, S, H, d)`` layout and passes the (b, s, h) strides to the kernel, so
nothing is transposed or copied (the JAX dispatch transposed into the
kernel's ``(B, H, S, d)``).

``plan_flash`` (plain Python, reached by the CPU tests) picks the block's
rows: the ``gh`` query heads of a KV head's group times ``bq`` positions,
at most ``ROWS`` rows, so each K/V tile is read once per group; and the
cp.async variant where every q/k/v row is 16-byte aligned.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64, 128)
ROWS = 64                    # csrc kRows: query rows (positions x heads)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@dataclass(frozen=True)
class FlashPlan:
    gh: int                    # query heads of a group per block
    bq: int                    # query positions per block
    vec: bool                  # cp.async: q/k/v rows 16-byte aligned
    grid: Tuple[int, int, int]


def plan_flash(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> FlashPlan:
    """Block geometry for q (B, Sq, H, d), k/v (B, Skv, KVH, d) with unit
    stride along d."""
    width = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(
        t.stride(i) % width == 0 for i in range(3) if t.shape[i] > 1)
        for t in (q, k, v))
    B, Sq, H, _ = q.shape
    return _plan_flash(B, Sq, H, k.shape[2], vec)


@functools.lru_cache(maxsize=1024)
def _plan_flash(B: int, Sq: int, H: int, KVH: int, vec: bool) -> FlashPlan:
    G = H // KVH
    gh = min(G, ROWS)
    bq = ROWS // gh
    grid = (-(-Sq // bq) * -(-G // gh), KVH, B)
    if grid[0] >= 2 ** 31 or grid[1] >= 2 ** 16 or grid[2] >= 2 ** 16:
        raise ValueError(f"flash_attention: grid {grid} too large")
    return FlashPlan(gh, bq, vec, grid)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) CUDA tensors of one dtype ->
    (B, Sq, H, d).  With ``causal`` the queries are the last Sq positions
    of the KV sequence, so Sq <= Skv."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KVH, d) or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} KV heads")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal Sq {Sq} > Skv {Skv}")
    if Skv >= 2 ** 31:
        raise ValueError(f"flash_attention: Skv {Skv} >= 2^31")
    code = _build.check_inputs("flash_attention", q, k, v)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    plan = plan_flash(q, k, v)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    launch = _build.entry("flash_attention", _ARGTYPES)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KVH, Sq, Skv, d, *strides, 1.0 / math.sqrt(d),
                 int(causal), plan.gh, plan.bq, int(plan.vec), code,
                 _build.stream())
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return o
