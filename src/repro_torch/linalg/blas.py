"""Real BLAS/LAPACK execution + timing on the card: the 'measured' mode.

The paper times real kernels on Stampede2.  Here the same role is played by
the local kernels of a distributed factorization run on the card (or, with
``device="cpu"``, on the host) and timed with perf_counter.  A
``MeasuredTimer`` plugs into the simmpi ``Runtime`` in place of the
stochastic cost model: compute signatures are executed for real;
communication signatures (which have no local realization) go to the cost
model.

The port of ``repro.linalg.blas``.  Operands are drawn in the reference's
order from one seeded NumPy generator (float64 draws cast to float32, as
``jnp.asarray`` casts them with x64 off) and cached per signature, so that
timing measures the kernel, not allocation.  Realizations:

- gemm, syrk (``a @ a.T`` on the transposed view), trmm (``tril(l) @ b``,
  the ``tril`` inside the timed call) and ormqr/tpmqrt (timed as a gemm,
  as in the reference): ``repro_torch.kernels.ops.matmul``, the
  hand-written CUDA matmul on the card;
- trsm, trtri, potrf and geqrf/tpqrt: ``torch.linalg.solve_triangular``,
  ``cholesky`` and ``qr(mode="r")`` -- library calls in the reference too
  (``jax.scipy``/``jnp.linalg``);
- blk2cyc: a copy.

The first call of each signature runs outside the timed region (handle
creation and library set-up, the reference's compile); each timed call
waits for the current stream only, the counterpart of the reference's
``block_until_ready`` on its one output.  The timer holds the card: run it
in one process at a time, and never fork after it has run (a
``SimBackend`` sweep with ``workers > 1`` forks; use ``workers=1`` or a
``RemoteExecutor``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.signatures import Signature
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.simmpi.costmodel import CostModel


def _gemm(a, b):
    return ops.matmul(a, b)


def _syrk(a):
    return ops.matmul(a, a.T)


def _trmm(l, b):
    return ops.matmul(torch.tril(l), b)


def _trsm(l, b):
    return torch.linalg.solve_triangular(l, b, upper=False)


def _potrf(a):
    return torch.linalg.cholesky(a)


def _trtri(l):
    return torch.linalg.solve_triangular(
        l, torch.eye(l.shape[0], dtype=l.dtype, device=l.device),
        upper=False)


def _geqrf(a):
    return torch.linalg.qr(a, mode="r")[1]


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return np.asarray(a @ a.T + n * np.eye(n), dtype=np.float64)


def _tri(rng, n):
    return np.asarray(np.tril(rng.standard_normal((n, n))) + n * np.eye(n),
                      dtype=np.float64)


class MeasuredTimer:
    """timer(sig, rng) -> seconds; executes compute kernels for real on
    ``device`` (``None``: the card)."""

    def __init__(self, comm_model: Optional[CostModel] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.comm_model = comm_model
        self.device = resolve_device(device)
        self._cache: Dict[Signature, tuple] = {}
        self._warmed: set = set()
        self._rng = np.random.default_rng(seed)
        self.calls = 0

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(x, dtype=np.float32),
                            device=self.device)

    def _operands(self, sig: Signature):
        ops_ = self._cache.get(sig)
        if ops_ is not None:
            return ops_
        rng, t = self._rng, self._t
        n, p = sig.name, sig.params
        if n == "gemm":
            m, nn, k = int(p[0]), int(p[1]), int(p[2])
            ops_ = (_gemm, (t(rng.standard_normal((m, k))),
                            t(rng.standard_normal((k, nn)))))
        elif n == "syrk":
            ops_ = (_syrk, (t(rng.standard_normal((int(p[0]), int(p[1])))),))
        elif n == "trmm":
            ops_ = (_trmm, (t(_tri(rng, int(p[0]))),
                            t(rng.standard_normal((int(p[0]), int(p[1]))))))
        elif n == "trsm":
            ops_ = (_trsm, (t(_tri(rng, int(p[0]))),
                            t(rng.standard_normal((int(p[0]), int(p[1]))))))
        elif n == "potrf":
            ops_ = (_potrf, (t(_spd(rng, int(p[0]))),))
        elif n == "trtri":
            ops_ = (_trtri, (t(_tri(rng, int(p[0]))),))
        elif n in ("geqrf", "tpqrt"):
            m = int(p[0]) if n == "geqrf" else 2 * int(p[1])
            ops_ = (_geqrf, (t(rng.standard_normal(
                (max(m, int(p[1])), int(p[1])))),))
        elif n in ("ormqr", "tpmqrt"):
            m, k = int(p[0]), int(p[-1])
            ops_ = (_gemm, (t(rng.standard_normal((m, k))),
                            t(rng.standard_normal((k, m)))))
        elif n == "blk2cyc":
            nb = max(int(p[0]) // 8, 1)
            ops_ = ("copy", (t(rng.standard_normal(nb)),))
        else:
            raise KeyError(f"no measured realization for {sig}")
        self._cache[sig] = ops_
        return ops_

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def __call__(self, sig: Signature, rng: np.random.Generator) -> float:
        if sig.kind == "comm":
            if self.comm_model is None:
                raise RuntimeError("measured mode needs a comm cost model")
            return self.comm_model.sample(sig, rng)
        fn, args = self._operands(sig)
        self.calls += 1
        if fn == "copy":
            t0 = time.perf_counter()
            args[0].clone()
            self._sync()
            return time.perf_counter() - t0
        if sig not in self._warmed:
            # library set-up outside the timed region on first use
            fn(*args)
            self._sync()
            self._warmed.add(sig)
        t0 = time.perf_counter()
        fn(*args)
        self._sync()
        return time.perf_counter() - t0
