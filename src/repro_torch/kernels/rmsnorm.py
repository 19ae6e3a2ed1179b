"""RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Port of ``repro.kernels.rmsnorm`` (Pallas ``_rmsnorm_kernel``).  The plain
version is ``ref.rmsnorm_ref``; ``ops.rmsnorm`` picks between the two by
the tensors' device.  x is passed with its row stride, so a strided view
(``big[:, :D]``) is read in place; w is read in its own dtype (f32 or
bf16), never converted.

The kernel has three variants, and ``plan_rmsnorm`` (plain Python, so the
CPU tests reach it) picks one and its launch geometry from the shape, row
stride, dtypes and pointer alignment:

* **warp** (aligned rows of at most ``32 * MAX_NV`` 16-byte vectors: D <=
  1024 f32 / 2048 bf16): a warp per row, 4-8 rows a block;
* **block** (aligned rows of at most ``512 * MAX_NV`` vectors): the fewest
  of 128/256/512 threads per row that hold it in ``BLOCK_NV`` vectors a
  thread (all 512 beyond that);
* **scalar** (anything else): element loads, two passes over the row.

Choosing a variant is not a fallback: a launch that fails raises, and no
call is retried another way.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from . import _build

MAX_NV = 8                   # csrc kMaxNV: 16-byte vectors a thread holds
BLOCK_NV = 4                 # block variant: vectors a thread, if it can
ROW_THREADS = (128, 256, 512)
THREADS_PER_SM = 2048        # the grid stops at what the SMs hold
VARIANTS = {"warp": 0, "block": 1, "scalar": 2}   # csrc enum Variant

# x, w, y, the plan's parameters (int64[11]), eps, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p]


@dataclass(frozen=True)
class RmsnormPlan:
    variant: str               # "warp", "block" or "scalar"
    nv: int                    # 16-byte vectors of x a thread holds
    threads: int               # per block
    rows_per_block: int        # warp variant: one row per warp
    grid: int                  # blocks; each walks rows grid-stride
    # the C entry's parameter block (csrc/rmsnorm.cu), built once per plan
    params: ctypes.Array = field(default=None, compare=False, repr=False)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def variants_for(D: int, stride: int, dtype, aligned: bool = True):
    """The variants that can take rows of D elements of ``dtype`` at row
    stride ``stride``, in the order the plan prefers them."""
    V = 16 // dtype.itemsize
    vec = aligned and D % V == 0 and stride % V == 0
    fits = {"warp": vec and D // V <= 32 * MAX_NV,
            "block": vec and D // V <= ROW_THREADS[-1] * MAX_NV,
            "scalar": True}
    return tuple(v for v, ok in fits.items() if ok)


@functools.lru_cache(maxsize=4096)
def plan_rmsnorm(rows: int, D: int, stride: int, dtype, w_dtype,
                 aligned: bool = True, sms: int = _build.H100_SMS,
                 variant: str | None = None) -> RmsnormPlan:
    """The variant and launch geometry for ``rows`` rows of D elements of
    ``dtype`` at row stride ``stride`` with a (D,) weight of ``w_dtype``,
    with x's and w's pointers 16-byte aligned or not, on a card with
    ``sms`` SMs.  ``variant`` forces one (chip_smoke.py holds each against
    the plain version); a variant that cannot take the shape raises.
    Cached: the serving path asks for a few shapes."""
    if rows < 1 or D < 1:
        raise ValueError(f"rmsnorm: no plan for {rows} rows of {D}")
    fits = variants_for(D, stride, dtype, aligned)
    if variant is None:
        variant = fits[0]
    elif variant not in fits:
        raise ValueError(f"rmsnorm: the {variant} variant cannot take D {D}"
                         f" at stride {stride} (aligned: {aligned})")
    nvec = D // (16 // dtype.itemsize)
    if variant == "warp":
        rpb = min(8 if _cdiv(rows, 8) >= sms else 4, rows)
        threads, nv = 32 * rpb, _cdiv(nvec, 32)
    elif variant == "block":
        rpb = 1
        threads = next((t for t in ROW_THREADS
                        if _cdiv(nvec, t) <= BLOCK_NV), ROW_THREADS[-1])
        nv = _cdiv(nvec, threads)
    else:
        rpb, nv = 1, 0
        threads = min(ROW_THREADS[-1], _cdiv(D, 32) * 32)
    grid = min(_cdiv(rows, rpb), sms * (THREADS_PER_SM // threads))
    vals = (rows, D, stride, D, _build.DTYPE_CODES[dtype],
            _build.DTYPE_CODES[w_dtype], VARIANTS[variant], nv, threads, rpb,
            grid)
    return RmsnormPlan(variant, nv, threads, rpb, grid,
                       (ctypes.c_int64 * len(vals))(*vals))


def plan_for(x2: torch.Tensor, w: torch.Tensor,
             variant: str | None = None) -> RmsnormPlan:
    """``plan_rmsnorm`` for these CUDA tensors (x2: (rows, D), unit stride
    along D; w: (D,) contiguous) on their card."""
    rows, D = x2.shape
    return _plan(x2, w, rows, D, x2.stride(0), variant)


def _plan(x, w, rows, D, stride, variant=None):
    return plan_rmsnorm(rows, D, stride, x.dtype, w.dtype,
                        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                        _build.sm_count(x.device.index), variant)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                 plan: RmsnormPlan | None = None) -> torch.Tensor:
    """x: (..., D) CUDA tensor (f32 or bf16); w: (D,), f32 or bf16.  Rows
    are the flattened leading dims; the output has x's shape and dtype.
    ``plan`` overrides ``plan_rmsnorm``'s choice (for measuring each
    variant)."""
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)} != ({D},)")
    code = _build.check_inputs("rmsnorm", x)
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    w_code = _build.DTYPE_CODES.get(w.dtype)
    if w_code is None:
        raise TypeError(f"rmsnorm: w of {w.dtype}; the kernel takes "
                        f"{list(_build.DTYPE_CODES)}")
    if D > 1 and w.stride(0) != 1:
        w = w.contiguous()
    if x.is_contiguous():            # the serving path: no reshape at all
        x2, y = x, torch.empty_like(x)
        rows, stride = (x.numel() // D if D else 0), D
    else:
        x2 = x.reshape(-1, D)
        if D > 1 and x2.stride(1) != 1:
            x2 = x2.contiguous()
        rows, stride = x2.shape[0], x2.stride(0)
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or D == 0:
        return y
    if plan is None:
        plan = _plan(x2, w, rows, D, stride)
    elif tuple(plan.params[:6]) != (rows, D, stride, D, code, w_code):
        raise ValueError("rmsnorm: the plan was made for other tensors")
    launch = _build.entry("rmsnorm", _ARGTYPES)
    err = launch(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                 ctypes.addressof(plan.params), float(eps), _build.stream())
    _build.check(err, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return y
