"""Communication-avoiding tall-skinny QR (CANDMC's panel kernel) (port of
``repro.jaxdist.tsqr``).

One-level CAQR over the row axis: a local Householder QR of each row block,
an all-gather of the p (n x n) R factors, a redundant QR of the stacked
(p n, n) matrix, and a local product to recover this block's slice of Q.
Wire traffic is p n^2 (the R stack) instead of the m n a gather-based
panel factorization would move.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from .matmul3d import layout, replicated


def tsqr(a, mesh: DeviceMesh, axis: str = "x"):
    """a: (m, n) with m row-sharded over ``axis`` (m % p == 0, m/p >= n;
    either laid out so or moved there).  Returns (Q (m, n) row-sharded
    over ``axis``, R (n, n) replicated)."""
    dims = mesh.mesh_dim_names
    a = layout(a, mesh, (axis, None))
    p = mesh.size(dims.index(axis))
    n = a.shape[1]
    q1, r1 = torch.linalg.qr(a.to_local(), mode="reduced")
    # the R factors of the axis's ranks, stacked in their coordinate order
    stack = DTensor.from_local(
        r1[None], mesh, tuple(Shard(0) if d == axis else Replicate()
                              for d in dims), run_check=False).full_tensor()
    q2, r = torch.linalg.qr(stack.reshape(p * n, n), mode="reduced")
    i = mesh.get_local_rank(axis)
    q = ops.matmul(q1, q2[i * n:(i + 1) * n].contiguous())
    q = DTensor.from_local(q, mesh, a.placements, run_check=False)
    return q, replicated(r, mesh)
