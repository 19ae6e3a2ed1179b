"""Kernel signatures.

A *kernel* in the paper is "a routine with a particular input size".
Compute kernels are parameterized on the routine name plus matrix dimensions
and BLAS flags (§V.D); communication kernels are parameterized on message
size and the sub-communicator's (size, stride) relative to the world
communicator, with point-to-point treated as a size-2 sub-communicator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Signature:
    """Hashable kernel signature.

    kind   -- 'comp' or 'comm'
    name   -- routine name ('gemm', 'potrf', 'bcast', 'send', ...)
    params -- compute: (dims..., flags...); comm: (nbytes, comm_size, comm_stride)
    """

    kind: str
    name: str
    params: Tuple

    def __str__(self) -> str:  # compact, stable, log-friendly
        p = ",".join(str(x) for x in self.params)
        return f"{self.kind}:{self.name}({p})"


class SignatureInterner:
    """Dense-integer interning of Signatures (engine hot path).

    Every Signature observed by the simulator is assigned a small dense id
    at creation; all per-kernel tables in the Critter engine are indexed by
    these ids (list/ndarray columns) instead of hashing the frozen
    dataclass on every event.  Ids are dense per interner and monotonically
    increasing; ``sigs`` is the live id -> Signature list (append-only, so
    holders of a reference always see newly interned signatures).  The
    engine uses one interner per simmpi ``World`` so a study's tables are
    sized by its own kernel count; the module-level ``INTERNER`` serves
    standalone uses.
    """

    __slots__ = ("_ids", "sigs")

    def __init__(self):
        self._ids: Dict[Signature, int] = {}
        self.sigs: List[Signature] = []

    def intern(self, sig: Signature) -> int:
        sid = self._ids.get(sig)
        if sid is None:
            sid = len(self.sigs)
            self._ids[sig] = sid
            self.sigs.append(sig)
        return sid

    def sig_of(self, sid: int) -> Signature:
        return self.sigs[sid]

    def __len__(self) -> int:
        return len(self.sigs)


#: standalone module-level interner for ad-hoc/test use.  NOT the engine's
#: id space: the simulator interns into ``World.interner``, and ids from
#: the two namespaces are not interchangeable — never pass an id from one
#: interner to tables indexed by another.
INTERNER = SignatureInterner()


def intern_sig(sig: Signature) -> int:
    """Intern ``sig`` in the standalone module-level interner (see the
    INTERNER note — engine ids come from ``World.interner``)."""
    return INTERNER.intern(sig)


def sig_of(sid: int) -> Signature:
    """Resolve a standalone-interner id back to its (equal) Signature."""
    return INTERNER.sigs[sid]


def comp_sig(name: str, *params) -> Signature:
    return Signature("comp", name, tuple(params))


def comm_sig(name: str, nbytes: int, comm_size: int, comm_stride: int) -> Signature:
    """Communication-kernel signature.

    Message sizes are bucketed to powers of two so that a gradually shrinking
    message (e.g. CANDMC's trailing-matrix broadcasts) maps onto a bounded
    number of signatures, mirroring the paper's observation that kernels with
    many distinct input sizes limit modeling opportunities but nearby sizes
    behave identically.
    """
    return Signature("comm", name, (_bucket(nbytes), comm_size, comm_stride))


def p2p_sig(name: str, nbytes: int) -> Signature:
    """Point-to-point configurations are treated as size-2 sub-communicators
    (paper §V.D)."""
    return Signature("comm", name, (_bucket(nbytes), 2, 0))


def _bucket(nbytes: int) -> int:
    if nbytes <= 0:
        return 0
    return 1 << (int(nbytes - 1).bit_length())


def structural_key(sig: Signature, world_size: int) -> str:
    """World-independent identity of a kernel signature, for cross-study
    statistics transfer (``repro.api.transfer``).

    Two studies only share a ``Signature`` object space per interner, and a
    comm signature's ``(comm_size, comm_stride)`` is meaningful only
    relative to its own world.  The structural key normalizes that away so
    banks built on one machine geometry can seed another:

    - compute kernels are already world-independent: the key is the
      compact ``str(sig)`` form (routine + dims/flags);
    - communication kernels keep the power-of-two byte bucket and express
      cartesian sub-communicators as *fractions of the world*:
      ``comm_size / world_size`` and (for strided channels) ``comm_stride
      / world_size`` as reduced fractions, with stride 1 (contiguous
      fiber) kept verbatim.  A full-world bcast therefore matches a
      full-world bcast at any processor count, and a strided fiber
      matches the same relative grid shape.  Stride 0 marks p2p and
      non-cartesian rank sets, whose sizes are absolute (a pairwise
      exchange is a pairwise exchange at any world size) and are kept
      verbatim.

    Keys are plain strings (stable, log-friendly, JSON-dict-ready).
    """
    if sig.kind != "comm":
        return str(sig)
    nbytes, size, stride = sig.params
    w = max(int(world_size), 1)

    def frac(x: int) -> str:
        g = math.gcd(int(x), w) or 1
        num, den = int(x) // g, w // g
        return str(num) if den == 1 else f"{num}/{den}"

    if stride == 0:        # p2p / non-cartesian: absolute size
        return f"comm:{sig.name}(b{nbytes},s{size},t0)"
    s = "1" if stride == 1 else frac(stride)
    return f"comm:{sig.name}(b{nbytes},s{frac(size)},t{s})"


def flops_of(sig: Signature) -> float:
    """Analytic flop count for the BLAS/LAPACK compute signatures used by the
    linalg case studies — consumed by the cost model and by the beyond-paper
    extrapolation features.  Dims convention documented per-routine."""
    if sig.kind != "comp":
        return 0.0
    n = sig.name
    p = sig.params
    if n == "gemm":      # (m, n, k)
        m, nn, k = p[0], p[1], p[2]
        return 2.0 * m * nn * k
    if n == "syrk":      # (n, k): C (n x n) += A (n x k) A^T
        return float(p[0]) * p[0] * p[1]
    if n == "trsm":      # (m, n): triangular solve with m x m tri, n rhs
        return float(p[0]) * p[0] * p[1]
    if n == "trmm":      # (m, n)
        return float(p[0]) * p[0] * p[1]
    if n == "potrf":     # (n,)
        return p[0] ** 3 / 3.0
    if n == "trtri":     # (n,)
        return p[0] ** 3 / 3.0
    if n == "geqrf":     # (m, n) tall-skinny QR panel
        m, nn = p[0], p[1]
        return 2.0 * m * nn * nn
    if n == "ormqr":     # (m, n, k) apply Q
        return 4.0 * p[0] * p[1] * p[2]
    if n == "tpqrt":     # (m, n) triangular-pentagonal QR
        return 2.0 * p[0] * p[1] * p[1]
    if n == "tpmqrt":    # (m, n, k)
        return 4.0 * p[0] * p[1] * p[2]
    if n == "blk2cyc":   # (nbytes,) data redistribution — bandwidth bound
        return 0.0
    # LM-framework kernels carry explicit flops in params[-1] by convention
    if p and isinstance(p[-1], float):
        return p[-1]
    return 0.0


def bytes_of(sig: Signature) -> float:
    """Approximate bytes moved (8-byte words for linalg)."""
    if sig.kind == "comm":
        return float(sig.params[0])
    n, p = sig.name, sig.params
    w = 8.0
    if n == "gemm":
        m, nn, k = p[0], p[1], p[2]
        return w * (m * k + k * nn + 2 * m * nn)
    if n in ("syrk",):
        return w * (p[0] * p[1] + p[0] * p[0])
    if n in ("trsm", "trmm"):
        return w * (p[0] * p[0] / 2 + 2 * p[0] * p[1])
    if n in ("potrf", "trtri"):
        return w * p[0] * p[0]
    if n in ("geqrf", "tpqrt"):
        return w * 2 * p[0] * p[1]
    if n in ("ormqr", "tpmqrt"):
        return w * (p[0] * p[1] * 2 + p[0] * p[2])
    if n == "blk2cyc":
        return float(p[0])
    return 0.0
