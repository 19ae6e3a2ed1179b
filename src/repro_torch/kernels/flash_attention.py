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
at most ``ROWS`` rows, so each K/V tile is read once per group; the KV
tile ``bk`` (``kv_tile``: the caller's KV chunk clamped to Skv as the
Pallas kernel clamps its ``bk``, then the smallest of ``BK_TILES`` that
holds it; the serving default where the caller names none); and the
cp.async variant where every q/k/v row is 16-byte aligned.

The backward pass (``flash_attention_bwd_cuda``, ``csrc/
flash_attention_bwd.cu``, f32 and bf16) recomputes the probabilities from
the per-row log-sum-exp that the forward writes when asked (``with_lse``).
``plan_flash_bwd`` picks its geometry: the KV tile (``kv_tile``, as the
forward), the block's warps and rows a chunk (per dtype and head width),
the dK/dV blocks a key tile (``splits``: more than one only where a key
tile's rows are many, as in long prompts) and the grid, which interleaves
the dK/dV blocks (early keys first) with the dQ blocks (late rows first) so
the heaviest of both start first.  ``bwd_scratch`` sizes the split key
tiles' workspace and counters from the values the C entry is given.
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
BK_TILES = (16, 32, 64)      # csrc: the instantiated KV tiles
# the KV tile where the caller names no chunk (the serving path's)
DEFAULT_BK = {torch.float32: 32, torch.bfloat16: 64}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 6
                 + [ctypes.c_int64] * 15
                 + [ctypes.c_float] + [ctypes.c_int] * 9 + [ctypes.c_void_p])
# backward: a dK/dV block's rows are cut into splits only where each keeps
# at least this many chunks of rows
SPLIT_MIN_CHUNKS = 4
MAX_SPLITS = 16


@dataclass(frozen=True)
class FlashPlan:
    gh: int                    # query heads of a group per block
    bq: int                    # query positions per block
    vec: bool                  # cp.async: q/k/v rows 16-byte aligned
    grid: Tuple[int, int, int]
    bk: int = 32               # keys per KV tile


def kv_tile(bk, Skv: int, dtype) -> int:
    """The KV tile for a caller's KV chunk ``bk`` (None: the serving
    default): clamped to Skv as the Pallas kernel clamps its ``bk``, then
    the smallest instantiated tile that holds it (the largest beyond)."""
    if bk is None:
        return DEFAULT_BK[dtype]
    want = max(1, min(int(bk), Skv))
    return next((t for t in BK_TILES if t >= want), BK_TILES[-1])


def plan_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bk=None) -> FlashPlan:
    """Block geometry for q (B, Sq, H, d), k/v (B, Skv, KVH, d) with unit
    stride along d, for a KV chunk ``bk`` (None: the serving default)."""
    width = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(
        t.stride(i) % width == 0 for i in range(3) if t.shape[i] > 1)
        for t in (q, k, v))
    B, Sq, H, _ = q.shape
    return _plan_flash(B, Sq, H, k.shape[2], vec,
                       kv_tile(bk, k.shape[1], q.dtype))


@functools.lru_cache(maxsize=1024)
def _plan_flash(B: int, Sq: int, H: int, KVH: int, vec: bool,
                bk: int = 32) -> FlashPlan:
    G = H // KVH
    gh = min(G, ROWS)
    bq = ROWS // gh
    grid = (-(-Sq // bq) * -(-G // gh), KVH, B)
    if grid[0] >= 2 ** 31 or grid[1] >= 2 ** 16 or grid[2] >= 2 ** 16:
        raise ValueError(f"flash_attention: grid {grid} too large")
    return FlashPlan(gh, bq, vec, grid, bk)


@dataclass(frozen=True)
class FlashBwdPlan:
    dtype: torch.dtype
    tile: int                  # keys per KV tile (csrc BK)
    warps: int                 # warps a block
    rows: int                  # (position, head) rows a chunk (csrc RC)
    splits: int                # dK/dV blocks a key tile
    vec: bool                  # cp.async: q/k/v/o/dO rows 16-byte aligned
    grid: Tuple[int, int, int]
    kv_blocks: int             # of grid[0]: ktiles x splits dK/dV blocks
    q_blocks: int              # ... and the dQ blocks of `rows` rows each
    Sq: int
    Skv: int
    G: int                     # query heads a KV head
    causal: bool


def _bwd_geometry(dtype, d: int, tile: int) -> Tuple[int, int]:
    """(warps, rows a chunk) of the backward kernel's instantiation
    (csrc ``Geo``): bf16 4 warps of 16 rows; f32 4 keys x 4 rows register
    tiles, 64 rows a chunk; at d 128 4 x 2 tiles and 32 rows (shared
    memory and registers)."""
    if dtype == torch.bfloat16:
        return 4, 64
    rows, tile_rows = (32, 2) if d > 64 else (64, 4)
    return tile * rows // (4 * tile_rows) // 32, rows


def plan_flash_bwd(q, k, v, o, do, bk=None, *,
                   causal: bool = True) -> FlashBwdPlan:
    """Backward geometry for q/o/do (B, Sq, H, d), k/v (B, Skv, KVH, d)
    with unit stride along d, for the forward's KV chunk ``bk``."""
    width = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(
        t.stride(i) % width == 0 for i in range(3) if t.shape[i] > 1)
        for t in (q, k, v, o, do))
    B, Sq, H, d = q.shape
    Skv = k.shape[1]
    return _plan_flash_bwd(q.dtype, B, Sq, Skv, H, k.shape[2], d, vec,
                           kv_tile(bk, Skv, q.dtype), causal)


@functools.lru_cache(maxsize=1024)
def _plan_flash_bwd(dtype, B: int, Sq: int, Skv: int, H: int, KVH: int,
                    d: int, vec: bool, tile: int,
                    causal: bool) -> FlashBwdPlan:
    G = H // KVH
    warps, rows = _bwd_geometry(dtype, d, tile)
    nrows = Sq * G
    # the heaviest key tile sees all nrows rows (4 products over `tile`
    # keys); the heaviest dQ block all Skv keys (3 products over `rows`
    # rows): cut the first so a share weighs about half the second (finer
    # blocks pack the grid's tail better), keeping at least
    # SPLIT_MIN_CHUNKS chunks a share
    want = -(-8 * tile * nrows // (3 * rows * Skv))
    splits = max(1, min(want, nrows // (SPLIT_MIN_CHUNKS * rows),
                        MAX_SPLITS))
    ktiles = -(-Skv // tile)
    kv_blocks, q_blocks = ktiles * splits, -(-nrows // rows)
    grid = (kv_blocks + q_blocks, KVH, B)
    if grid[0] >= 2 ** 31 or grid[1] >= 2 ** 16 or grid[2] >= 2 ** 16 \
            or nrows >= 2 ** 31:
        raise ValueError(f"flash_attention_bwd: grid {grid} too large")
    return FlashBwdPlan(dtype, tile, warps, rows, splits, vec, grid,
                        kv_blocks, q_blocks, Sq, Skv, G, causal)


def bwd_scratch(B: int, KVH: int, Skv: int, tile: int, splits: int,
                d: int) -> Tuple[int, int]:
    """(f32 workspace, int32 counters) the backward kernel uses for these
    C entry arguments: with splits > 1, every key tile of every (batch, KV
    head) holds ``splits`` partials of dK and dV (2 tile d floats each) and
    one counter; with one split, none."""
    if splits <= 1:
        return 0, 0
    tiles = B * KVH * -(-Skv // tile)
    return tiles * splits * 2 * tile * d, tiles


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_shapes(q, k, v, causal: bool) -> None:
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, bk=None,
                         with_lse: bool = False):
    """q: (B, Sq, H, d); k/v: (B, Skv, KVH, d) CUDA tensors of one dtype ->
    (B, Sq, H, d).  With ``causal`` the queries are the last Sq positions
    of the KV sequence, so Sq <= Skv.  ``bk``: the KV chunk (``kv_tile``).
    ``with_lse``: also return the rows' log-sum-exp, f32 (B, H, Sq), for
    the backward pass."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    code = _build.check_inputs("flash_attention", q, k, v)
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    plan = plan_flash(q, k, v, bk)
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    launch = _build.entry("flash_attention", _ARGTYPES)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, H, KVH, Sq, Skv, d, *strides, 1.0 / math.sqrt(d),
                 int(causal), plan.gh, plan.bq, plan.bk, int(plan.vec), code,
                 _build.stream())
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             bk=None, plan: FlashBwdPlan | None = None):
    """Gradients (dq, dk, dv) of ``flash_attention_cuda`` for output
    gradient ``do`` (q's shape), from the forward's output ``o`` and its
    ``lse`` (B, H, Sq, f32); q, k, v, o and do CUDA tensors of one dtype,
    f32 or bf16 (anything else raises ``TypeError``); the gradients come
    out in it.  ``bk``: the forward's KV chunk; ``plan`` overrides
    ``plan_flash_bwd``'s (tests: the C entry refuses a plan that is not its
    own).  One launch of csrc/flash_attention_bwd.cu: its dK/dV blocks and
    dQ blocks share the grid."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    code = _build.check_inputs("flash_attention_bwd", q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} != q {tuple(q.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be f32 (B, H, Sq) "
                         "contiguous on q's device")
    q, k, v, o, do = (_unit_last(t) for t in (q, k, v, o, do))
    dq = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, KVH, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if plan is None:
        plan = plan_flash_bwd(q, k, v, o, do, bk, causal=causal)
    stream = _build.stream()
    ws = cnt = None
    if plan.splits > 1:
        # sized from what the C entry is given, not from the plan's other
        # fields, so no plan can send the kernel past its scratch
        ws, cnt = _build.scratch(q.device, stream, *bwd_scratch(
            B, KVH, Skv, plan.tile, plan.splits, d))
    strides = [t.stride(i) for t in (q, k, v, o, do) for i in range(3)]
    launch = _build.entry("flash_attention_bwd", _BWD_ARGTYPES)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if cnt is None else cnt.data_ptr(),
                 B, H, KVH, Sq, Skv, d, *strides, 1.0 / math.sqrt(d),
                 int(causal), plan.tile, code, plan.warps, plan.rows,
                 plan.splits, int(plan.vec), plan.kv_blocks, plan.q_blocks,
                 stream)
    _build.check(err, "flash_attention_bwd")
    _build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv
