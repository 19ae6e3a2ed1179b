"""What each kernel costs, and the card's peaks that a cost is read against.

``kernel_cost`` is the bytes each kernel must move (every input read once,
every output written once) and the operations it does, on given inputs:
the bound of ``chip_smoke.py``'s kernel rows and the charge of a kernel op
in the dry-run (``launch/trace_cost.py``), which traces the step on fake
tensors and launches nothing.  Attention counts the visible (query, key)
pairs of the causal mask, which the kernel visits, not the S x S scores
that its plain version materializes.

``charging`` collects the charges: a kernel op on fake tensors
(``kernels/ops.py``) adds its cost to every collector active on its
thread, and nothing else does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

# NVIDIA H100 SXM 80GB at its 700 W power limit, the data sheet's dense
# peaks: HBM3 bandwidth, bf16 on the tensor cores, f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the slowest link a 16-wide mesh axis crosses on H100 nodes of 8 cards:
# one 400 Gb/s NDR InfiniBand port per GPU (the node's NVLink is faster)
LINK_BYTES_PER_S = 50e9
# the memory an NVIDIA H100 80GB HBM3 reports to
# torch.cuda.get_device_properties(0).total_memory (power limit 700.00 W;
# chip_smoke.py's [dryrun] phase reads it again and holds it to this)
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_MEMORY_BYTES = 85_017_493_504


def causal_pairs(sq: int, skv: int, q_offset=None) -> int:
    """The (query, key) pairs a causal mask leaves visible, query i at key
    position ``q_offset`` + i (None: skv - sq + i, the queries aligned to
    the end of the keys): the sum over i < sq of q_offset + i + 1, clamped
    to [0, skv]."""
    off = skv - sq if q_offset is None else q_offset
    lo = min(sq, max(0, -off))             # rows [0, lo) see no key
    hi = min(sq, max(lo, skv - off - 1))   # rows [hi, sq) see all skv
    return ((hi - lo) * (off + 1) + (lo + hi - 1) * (hi - lo) // 2
            + (sq - hi) * skv)


def _elem(t: torch.Tensor) -> int:
    return t.element_size()


def kernel_cost(name: str, args, q_offset=None) -> Tuple[int, int]:
    """(bytes, flops) that kernel ``name`` needs on these inputs: matmul
    (a, b), rmsnorm (x, w), flash_attention (q, k, v) causal with its
    queries at ``q_offset`` (``causal_pairs``), and the backward kernels
    rmsnorm_bwd (x, w) and flash_attention_bwd (q, k, v, ``q_offset``).
    Attention reads k and v up to the last query's causal limit only (the
    kernels never load a tile past it) and writes dk and dv whole."""
    if name == "matmul":
        a, b = args
        (M, K), N = a.shape, b.shape[1]
        return (M * K + K * N + M * N) * _elem(a), 2 * M * N * K
    if name == "rmsnorm":
        x, w = args
        return 2 * x.numel() * _elem(x) + w.numel() * _elem(w), \
            4 * x.numel()
    if name == "rmsnorm_bwd":
        # x and dy read, dx written, w read and dw written once; ~8 flops
        # an element
        x, w = args
        return 3 * x.numel() * _elem(x) + 2 * w.numel() * _elem(w), \
            8 * x.numel()
    q, k, v = args
    B, Sq, H, dk = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    off = Skv - Sq if q_offset is None else q_offset
    pairs = B * H * causal_pairs(Sq, Skv, off)
    seen = min(Skv, max(0, off + Sq))     # the keys the last query sees
    es = _elem(q)
    qo = q.numel() + B * Sq * H * dv               # q and o (or dq and dO)
    kv_seen = B * seen * k.shape[2] * (dk + dv)
    if name == "flash_attention":
        return (qo + kv_seen) * es, 2 * (dk + dv) * pairs
    if name == "flash_attention_bwd":
        # q, k, v, o, dO and lse read once, dq, dk, dv written once; per
        # visible pair 6 dk + 4 dv flops (S recomputed, dK and dQ over dk;
        # dP and dV over dv)
        nbytes = ((2 * qo + kv_seen + k.numel() + v.numel()) * es
                  + B * H * Sq * 4)
        return nbytes, (6 * dk + 4 * dv) * pairs
    raise ValueError(f"no cost for kernel {name!r}")


# the kernels whose flops are products (the dry-run's dot flops)
DOT_KERNELS = ("matmul", "flash_attention", "flash_attention_bwd")


@dataclass
class Charges:
    """Kernel charges: calls, bytes and flops by kernel."""

    calls: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, float] = field(default_factory=dict)
    flops: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, nbytes: float, flops: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes
        self.flops[name] = self.flops.get(name, 0.0) + flops


_local = threading.local()


def _active() -> List[Charges]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextmanager
def charging():
    """Collect the kernel charges made on this thread inside the block."""
    c = Charges()
    stack = _active()
    stack.append(c)
    try:
        yield c
    finally:
        stack.remove(c)


def charge(name: str, *args, q_offset=None) -> None:
    """Charge kernel ``name``'s cost on ``args`` (attention: at
    ``q_offset``) to the active collectors."""
    stack = _active()
    if stack:
        nbytes, flops = kernel_cost(name, args, q_offset)
        for c in stack:
            c.add(name, nbytes, flops)
