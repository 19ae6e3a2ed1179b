"""What the plain reference of every family shares (each family's own
equations are in its file, ``bench/families``): the products' precision,
float32 with TF32 off or a control's float8, and an MoE's expert capacity.
It imports nothing of the program.
"""

from __future__ import annotations

import torch


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t scaled by its largest magnitude, rounded to float8 e4m3, scaled
    back."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with every operand of the forward and of the backward's two
    products (a, b and the output's gradient) rounded to float8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, dc):
        qa, qb = ctx.saved_tensors
        qdc = _fp8(dc)
        return qdc @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qdc


class Precision:
    """The products' arithmetic: ``"float32"`` exact f32 (TF32 off), or a
    control's lower precision, ``"float8"``: each operand of a product,
    and in the backward each operand of its two products, scaled by its
    largest magnitude, rounded to float8 e4m3 and multiplied in f32."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float8":
            return _Fp8Product.apply(a, b)
        return a @ b


F32 = Precision()


def exact_f32() -> None:
    """Products in float32 as written: no TF32 anywhere (called before the
    reference runs, after the program's window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def capacity(pairs: int, n_experts: int, factor: float) -> int:
    """Rows per expert for ``pairs`` token-expert pairs: round(pairs / E *
    factor) (Python's rounding), at least 1, and from 256 pairs on a
    multiple of 256."""
    cap = int(max(1, round(pairs / n_experts * factor)))
    return -(-cap // 256) * 256 if pairs >= 256 else cap
