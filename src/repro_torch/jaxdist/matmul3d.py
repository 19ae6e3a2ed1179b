"""3D matrix multiplication (Agarwal et al. / ACS) over a (c, c, c) mesh
(port of ``repro.jaxdist.matmul3d``).

C(x,y) = sum_z A(x,z) . B(z,y): each of the c 'z' layers computes a
rank-K/c partial product from its A column-block and B row-block, and the
reduction over 'z' is the one all-reduce.  The broadcasts of Capital's
products become the redistribution of the operands to their (x, z) and
(z, y) layouts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..parallel.sharding import NamedSharding, P, distribute, placements

AXES = ("x", "y", "z")


def make_3d_mesh(c: int, device: DeviceLike = None) -> DeviceMesh:
    """c x c x c mesh with dims (x, y, z) over the c^3 ranks of the
    initialized process group (one rank a device)."""
    return init_device_mesh(resolve_device(device).type, (c, c, c),
                            mesh_dim_names=AXES)


def layout(x, mesh: DeviceMesh, spec) -> DTensor:
    """``x`` laid out by ``spec`` (a ``PartitionSpec`` over x, y, z): a
    DTensor is redistributed, a plain tensor that every rank holds whole
    is placed (each rank keeps its slice)."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    return distribute(x, NamedSharding(mesh, P(*spec)))


def _local(t: DTensor) -> torch.Tensor:
    t = t.to_local()
    return t if t.is_contiguous() else t.contiguous()


def matmul_3d(a, b, mesh: DeviceMesh, out_spec: Optional[tuple] = ("x", "y")
              ) -> DTensor:
    """a: (M, K) laid out P('x', 'z'); b: (K, N) laid out P('z', 'y')
    (either is moved there first); returns c: (M, N) laid out P('x', 'y'),
    replicated over z: each rank's local product (one ``ops.matmul``
    launch), then one all-reduce over 'z'."""
    a = layout(a, mesh, ("x", "z"))
    b = layout(b, mesh, ("z", "y"))
    c = ops.matmul(_local(a), _local(b))
    part = tuple(Partial() if d == "z" else p for d, p in zip(
        mesh.mesh_dim_names, placements(("x", "y"), mesh)))
    c = DTensor.from_local(c, mesh, part, run_check=False)
    return c.redistribute(mesh, placements(out_spec, mesh))


def replicated(t: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """A tensor that every rank holds whole, as a replicated DTensor."""
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
