"""Matrix product on the card: wrapper of ``csrc/matmul.cu``.

Port of ``repro.kernels.matmul`` (Pallas ``_matmul_kernel``).  The plain
version is ``ref.matmul_ref``; ``ops.matmul`` picks between the two by the
tensors' device.  A and B are passed with their strides, so a transposed
view (the tied head's ``embed.T``) is read in place, never copied.

The kernel has two paths, and ``plan_matmul`` (plain Python, so the CPU
tests reach it) picks one and its launch geometry from the shapes, strides,
dtype and pointer alignment:

* **skinny** (M <= ``skinny_max_m``): streams B once, MT rows of A per
  block, with K split over ``splits`` blocks where N alone gives too few
  blocks for the card; the splits' partials are summed in a fixed order
  inside the same launch (scratch from ``_build.scratch``);
* **tiled** (larger M): 128x128 tiles through a cp.async ring, bf16 on the
  tensor cores, f32 on FMA.  The bf16 weight gradient A^T dC, whose A has
  unit stride along M, stages A along M (``acol``) and, where its output
  tiles fill less than ``BLOCKS_PER_SM`` blocks an SM, splits its long K
  (the tokens) over ``splits`` blocks a tile, summed in a fixed order in
  the same launch.

Choosing a path is not a fallback: a launch that fails raises, and no call
is retried another way.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field, replace
from typing import Tuple

import torch

from .. import obs
from . import _build

# the skinny path takes M <= this, per dtype and per whether B fits twice
# in the L2 (then the blocks of other rows of A re-read it there, not from
# HBM): where it stops beating the tiled path on the H100 (chip_smoke.py's
# crossover rows; PERF.md).  bf16 beyond the L2 takes the tiled path at
# every M: it was faster there even at M = 1.
SKINNY_MAX_M = {(torch.float32, True): 512, (torch.float32, False): 32,
                (torch.bfloat16, True): 32, (torch.bfloat16, False): 0}
# ... except row-major B beyond the L2 (the tied head's backward dX = dC
# embed, K = 49152): there the tiled grid holds only N / 128 blocks, each
# walking all of K, and the skinny path (split K) won at every M timed
# (chip_smoke.py's crossover rows in PERF.md: f32 to 512, bf16 to 128)
SKINNY_MAX_M_ROWB_BEYOND_L2 = {torch.float32: 512, torch.bfloat16: 128}
# skinny: split K until the grid has 2 blocks per SM, and give each K split
# at most 2 blocks per SM, each walking tiles / blocks output tiles (the
# tied head's fastest cap; PERF.md)
BLOCKS_PER_SM = 2
# skinny: at most this many rows of A per block where B fits twice in the
# 50 MB L2: at M = 31, 4 rows beat 8 and 16 on every projection (PERF.md)
L2_REREAD_MT, L2_BYTES = 4, 50_000_000
A_STAGE_FLOATS = 8192        # csrc kAStage: A floats a skinny block stages
SK_WARPS = 8
TILE = 128                   # tiled path: BM = BN
TILE_BK = 64                 # csrc TileCfg<bf16>::BK: depth of a bf16 K tile
# tiled, A along M: no K split shallower than this many K tiles
MIN_SPLIT_KTILES = 8
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# rows of A per skinny block, per dtype (bf16 vectors hold 8 values, so 16
# rows would need 128 accumulators a thread)
SKINNY_MT = {torch.float32: (1, 2, 4, 8, 16), torch.bfloat16: (1, 2, 4, 8)}

# a, b, c, part, counters, the plan's parameters (int64[17]), stream
_ARGTYPES = [ctypes.c_void_p] * 7


@dataclass(frozen=True)
class MatmulPlan:
    path: str                  # "skinny" or "tiled"
    colb: bool                 # B read along K (unit stride along K)
    vec: bool                  # 16-byte vector loads are aligned (B's;
                               # tiled with A along K: A's too)
    grid: Tuple[int, int]      # (x, y) blocks; skinny: x walks the tiles
    mt: int = 0                # skinny: rows of A per block
    kchunk: int = 0            # skinny, acol: depth of one K split
    splits: int = 1            # skinny, acol: K splits (blockIdx.y / .z)
    tiles: int = 0             # skinny, acol: output tiles (split-K counters)
    bn: int = 0                # skinny: output columns per tile
    acol: bool = False         # tiled bf16: A staged along M by cp.async
    # the C entry's parameter block (csrc/matmul.cu), built once per plan
    params: ctypes.Array = field(default=None, compare=False, repr=False)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec_ok(aligned: bool, unit: int, other: int, width: int) -> bool:
    return aligned and unit == 1 and other % width == 0


def b_in_l2(K: int, N: int, dtype) -> bool:
    """B fits twice in the L2."""
    return 2 * K * N * ELEM_BYTES[dtype] <= L2_BYTES


def skinny_max_m(K: int, N: int, dtype, colb: bool = True) -> int:
    """The largest M that takes the skinny path for a (K, N) B, read along
    K (``colb``) or row-major."""
    in_l2 = b_in_l2(K, N, dtype)
    if not colb and not in_l2:
        return SKINNY_MAX_M_ROWB_BEYOND_L2[dtype]
    return SKINNY_MAX_M[dtype, in_l2]


@functools.lru_cache(maxsize=4096)
def plan_matmul(M: int, K: int, N: int, strides_a, strides_b, dtype,
                a_aligned: bool = True, b_aligned: bool = True,
                skinny_max: int | None = None,
                sms: int = _build.H100_SMS) -> MatmulPlan:
    """The path and launch geometry for (M, K) x (K, N) with A and B at
    16-byte aligned addresses or not, with strides ``(sam, sak)`` and
    ``(sbk, sbn)``, on a card with ``sms`` SMs.  ``skinny_max`` moves the
    threshold (chip_smoke.py forces each path with it).  Cached: the
    serving path asks for a few shapes."""
    (sam, sak), (sbk, sbn) = strides_a, strides_b
    V = 16 // ELEM_BYTES[dtype]
    colb = sbk == 1 and (sbn != 1 or N == 1)
    if skinny_max is None:
        skinny_max = skinny_max_m(K, N, dtype, colb)
    b_vec = (_vec_ok(b_aligned, sbk, sbn, V) if colb
             else _vec_ok(b_aligned, sbn, sbk, V))
    if M > skinny_max:
        a_vec = _vec_ok(a_aligned, sak, sam, V)
        grid = (_cdiv(N, TILE), _cdiv(M, TILE))
        if grid[0] >= 2 ** 31 or grid[1] >= 2 ** 16:
            raise ValueError(f"matmul: ({M}, {N}) exceeds the grid")
        # A along M (the weight gradient A^T dC), bf16: staged by vectors
        acol = (dtype == torch.bfloat16 and not a_vec
                and _vec_ok(a_aligned, sam, sak, V))
        if not acol:
            return _with_params(MatmulPlan("tiled", colb, b_vec and a_vec,
                                           grid), M, N, K, strides_a,
                                strides_b, dtype)
        # split K until the tiles reach BLOCKS_PER_SM blocks an SM, no split
        # shallower than MIN_SPLIT_KTILES K tiles
        tiles, ktiles = grid[0] * grid[1], max(1, _cdiv(K, TILE_BK))
        splits = max(1, min(BLOCKS_PER_SM * sms // tiles,
                            ktiles // MIN_SPLIT_KTILES))
        per = _cdiv(ktiles, splits)            # K tiles a split
        return _with_params(MatmulPlan("tiled", colb, b_vec, grid,
                                       kchunk=per * TILE_BK,
                                       splits=_cdiv(ktiles, per),
                                       tiles=tiles, acol=True),
                            M, N, K, strides_a, strides_b, dtype)
    mts = SKINNY_MT[dtype]
    mt = next((m for m in mts if m >= M), mts[-1])
    if b_in_l2(K, N, dtype):
        mt = min(mt, L2_REREAD_MT)
    bn = SK_WARPS * (8 if mt <= 4 else 4) if colb else 32 * V  # csrc BN
    tiles = _cdiv(M, mt) * _cdiv(N, bn)
    kmin = 32 * V if colb else 64
    kcap = A_STAGE_FLOATS // mt // 32 * 32
    max_blocks = BLOCKS_PER_SM * sms
    splits = max(1, min(_cdiv(max_blocks, tiles), _cdiv(K, kmin)))
    kchunk = min(kcap, max(32, _cdiv(_cdiv(K, splits), 32) * 32))
    splits = max(1, _cdiv(K, kchunk))
    if tiles >= 2 ** 31 or splits >= 2 ** 16:
        raise ValueError(f"matmul: ({M}, {K}, {N}) exceeds the grid")
    return _with_params(MatmulPlan("skinny", colb, b_vec,
                                   (min(tiles, max_blocks), splits),
                                   mt, kchunk, splits, tiles, bn),
                        M, N, K, strides_a, strides_b, dtype)


def _with_params(plan: MatmulPlan, M, N, K, strides_a, strides_b, dtype):
    """The plan with the C entry's parameter block (csrc/matmul.cu)."""
    vals = (M, N, K, *strides_a, *strides_b, _build.DTYPE_CODES[dtype],
            int(plan.path == "tiled") + int(plan.acol), int(plan.colb),
            int(plan.vec),
            plan.mt, plan.kchunk, plan.splits, plan.grid[0], plan.tiles,
            plan.bn)
    return replace(plan, params=(ctypes.c_int64 * len(vals))(*vals))


def plan_for(a: torch.Tensor, b: torch.Tensor,
             skinny_max: int | None = None) -> MatmulPlan:
    """``plan_matmul`` for these CUDA tensors on their card."""
    return plan_matmul(a.shape[0], a.shape[1], b.shape[1], a.stride(),
                       b.stride(), a.dtype, a.data_ptr() % 16 == 0,
                       b.data_ptr() % 16 == 0, skinny_max,
                       _build.sm_count(a.device.index))


def matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                plan: MatmulPlan | None = None) -> torch.Tensor:
    """a: (M, K), b: (K, N), CUDA tensors of one dtype (f32 or bf16), any
    strides -> (M, N) contiguous in that dtype; f32 accumulation.  ``plan``
    overrides ``plan_matmul``'s choice (for measuring both paths)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    code = _build.check_inputs("matmul", a, b)
    (M, K), N = a.shape, b.shape[1]
    if plan is None:
        plan = plan_for(a, b)
    elif tuple(plan.params[:8]) != (M, N, K, *a.stride(), *b.stride(), code):
        raise ValueError("matmul: the plan was made for other tensors")
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    stream = _build.stream()
    part = cnt = None
    if plan.splits > 1:
        per_split = plan.tiles * TILE * TILE if plan.acol else M * N
        part, cnt = _build.scratch(a.device, stream, plan.splits * per_split,
                                   plan.tiles)
    if plan.acol:
        obs.count("matmul.acol", 1)
        obs.count("matmul.splits", plan.splits)
    launch = _build.entry("matmul", _ARGTYPES)
    err = launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 None if part is None else part.data_ptr(),
                 None if cnt is None else cnt.data_ptr(),
                 ctypes.addressof(plan.params), stream)
    _build.check(err, "matmul")
    _build.launches["matmul"] += 1
    return c
