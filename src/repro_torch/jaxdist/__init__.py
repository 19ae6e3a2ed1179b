"""jaxdist -- the paper's dense linear algebra as real distributed programs
over a process group (port of ``repro.jaxdist``; the package keeps the
reference's name, though nothing in it is JAX).  The simmpi layer
*simulates* the schedules for the autotuning study; this package *executes*
them on a device mesh.

- matmul3d: Agarwal/ACS 3D matmul -- the operands laid out over two mesh
  dims each, the product reduced along the third (the communication pattern
  of Capital's Cholesky products);
- cholesky3d: Capital's recursive Cholesky (+ inverse) over the 3D mesh
  with a replicated base-case factorization (base strategy 2 of the paper);
- tsqr: communication-avoiding tall-skinny QR over the row axis (CANDMC's
  panel kernel).

Products are ``ops.matmul`` (the hand-written CUDA matmul on the card);
factorizations and triangular solves are ``torch.linalg``, as in
``linalg/blas.py``.  Layouts are DTensor placements made from the
reference's ``PartitionSpec``s (``parallel.sharding.placements``).
"""

from .matmul3d import make_3d_mesh, matmul_3d
from .cholesky3d import cholesky_3d
from .tsqr import tsqr

__all__ = ["matmul_3d", "make_3d_mesh", "cholesky_3d", "tsqr"]
