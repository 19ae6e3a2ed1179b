"""Capital's recursive Cholesky (+ triangular inverse) on the 3D mesh (port
of ``repro.jaxdist.cholesky3d``).

    [A11      ]   [L11     ] [L11^T L21^T]
    [A21  A22 ] = [L21  L22] [      L22^T]

Base case (paper strategy 2): the sub-block is gathered (replicated) and
factorized redundantly on every rank -- an all-gather + redundant
potrf/trtri (``torch.linalg``).  Products L21 = A21 L11^{-T} and S = A22 -
L21 L21^T run through the 3D matmul.  The inverse is maintained through
the recursion (Capital's inverse-based formulation):

    inv([L11 0; L21 L22]) = [Linv11 0; -Linv22 L21 Linv11, Linv22]

The block layouts P('x','y'), P('x','z') and P('z','y') are DTensor
placements; a quadrant of a laid-out block is taken from its gathered
copy (DTensor slices a sharded dim so), then laid out again.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .matmul3d import layout, matmul_3d, replicated


def _base(a: DTensor, mesh: DeviceMesh):
    """Replicated base-case factorization: L, L^{-1} (strategy 2)."""
    a = layout(a, mesh, ()).to_local()     # all-gather, factor redundantly
    l = torch.linalg.cholesky(a)
    linv = torch.linalg.solve_triangular(
        l, torch.eye(a.shape[0], dtype=a.dtype, device=a.device),
        upper=False)
    return replicated(l, mesh), replicated(linv, mesh)


def cholesky_3d(a, mesh: DeviceMesh, block: int):
    """a: (n, n) SPD, laid out P('x', 'y') (or moved there).  Returns (L,
    Linv) in the same layout.  n and block must be powers of two with
    block | n."""
    a = layout(a, mesh, ("x", "y"))
    n = a.shape[0]
    if n <= block:
        l, linv = _base(a, mesh)
        return layout(l, mesh, ("x", "y")), layout(linv, mesh, ("x", "y"))
    h = n // 2
    a11 = a[:h, :h]
    a21 = a[h:, :h]
    a22 = a[h:, h:]

    l11, linv11 = cholesky_3d(a11, mesh, block)
    # L21 <- A21 . L11^{-T}           (3D product)
    l21 = matmul_3d(layout(a21, mesh, ("x", "z")),
                    layout(linv11.T, mesh, ("z", "y")), mesh)
    # S <- A22 - L21 . L21^T          (3D symmetric update)
    s = layout(a22, mesh, ("x", "y")) - matmul_3d(
        layout(l21, mesh, ("x", "z")), layout(l21.T, mesh, ("z", "y")), mesh)
    l22, linv22 = cholesky_3d(s, mesh, block)
    # Linv21 <- -Linv22 . L21 . Linv11
    t = matmul_3d(layout(l21, mesh, ("x", "z")),
                  layout(linv11, mesh, ("z", "y")), mesh)
    linv21 = -matmul_3d(layout(linv22, mesh, ("x", "z")),
                        layout(t, mesh, ("z", "y")), mesh)

    zero = replicated(torch.zeros((h, h), dtype=a.dtype,
                                  device=a.to_local().device), mesh)
    l = torch.cat([torch.cat([l11, zero], dim=1),
                   torch.cat([l21, l22], dim=1)], dim=0)
    linv = torch.cat([torch.cat([linv11, zero], dim=1),
                      torch.cat([linv21, linv22], dim=1)], dim=0)
    return layout(l, mesh, ("x", "y")), layout(linv, mesh, ("x", "y"))
