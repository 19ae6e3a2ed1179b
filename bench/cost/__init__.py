"""The yardstick's arithmetic: the card's peaks, each kernel's least work,
and the work a cell's step needs.

A frozen copy of the arithmetic the program keeps in
``repro_torch/kernels/cost.py`` (the peaks, ``causal_pairs``, each kernel's
bytes and flops), so that a later change to the program cannot move the
benchmark's yardstick.  Every input byte is counted read once and every
output byte written once, whatever a kernel reads again; attention counts
the (query, key) pairs a causal mask leaves visible.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM 80GB at its 700 W power limit, the data sheet's dense
# peaks: HBM3 bandwidth, bf16 on the tensor cores, f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the peak a model's flops utilization is read against: bf16 dense
MFU_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Work:
    """Bytes and flops of some kernel work, and the least time the card
    takes for it: the larger of its flops over the dtype's peak and its
    bytes over the bandwidth, summed launch by launch."""

    bytes: float = 0.0
    flops: float = 0.0
    bound_s: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops,
                    self.bound_s + other.bound_s)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.flops * n, self.bound_s * n)

    __rmul__ = __mul__


def bound(nbytes: float, flops: float, dtype: str) -> Work:
    return Work(nbytes, flops, max(flops / PEAK_FLOPS[dtype],
                                   nbytes / HBM_BYTES_PER_S))


def matmul(M: int, K: int, N: int, dtype: str, n_weights: int = 1) -> Work:
    """C (M, N) = A (M, K) B (K, N): A and C once, B once per weight
    (``n_weights`` experts' (K, N) weights, each read once, the M rows
    shared among them)."""
    e = ELEM_BYTES[dtype]
    return bound((M * K + n_weights * K * N + M * N) * e, 2 * M * N * K,
                 dtype)


def causal_pairs(sq: int, skv: int, q_offset=None) -> int:
    """The (query, key) pairs a causal mask leaves visible, query i at key
    position ``q_offset`` + i (None: skv - sq + i), clamped to [0, skv]."""
    off = skv - sq if q_offset is None else q_offset
    lo = min(sq, max(0, -off))
    hi = min(sq, max(lo, skv - off - 1))
    return ((hi - lo) * (off + 1) + (lo + hi - 1) * (hi - lo) // 2
            + (sq - hi) * skv)


def flash(B: int, S: int, H: int, KVH: int, d: int, dtype: str,
          backward: bool = False) -> Work:
    """Causal self-attention over S positions, queries aligned with the
    keys: the forward reads q, k, v and writes o; the backward reads q, k,
    v, o, dO and the row log-sum-exp and writes dq, dk, dv.  Flops per
    visible pair: 4 d forward (S and P V), 10 d backward (S recomputed, dP,
    dV, dQ, dK)."""
    e = ELEM_BYTES[dtype]
    pairs = B * H * causal_pairs(S, S)
    qo = 2 * B * S * H * d
    kv = 2 * B * S * KVH * d
    if not backward:
        return bound((qo + kv) * e, 4 * d * pairs, dtype)
    return bound((2 * qo + 2 * kv) * e + B * H * S * 4, 10 * d * pairs,
                 dtype)
