"""linalg — the paper's application domain: distributed dense matrix
factorization schedules (§V) expressed as simmpi virtual-rank programs.

Four state-of-the-art implementations, with the paper's exact configuration
space structure:

- ``capital_cholesky`` — Capital's recursive bulk-synchronous Cholesky on a
  3D processor grid (block size x 3 base-case strategies);
- ``slate_cholesky``   — SLATE's task-based tile Cholesky on a 2D grid
  (tile size x lookahead depth), nonblocking p2p;
- ``candmc_qr``        — CANDMC's pipelined bulk-synchronous 2D Householder
  QR (block size x processor grid);
- ``slate_qr``         — SLATE's task-based 2D QR with internally-blocked
  panels (inner width x panel width x grid).

``blas`` provides real local jnp BLAS/LAPACK execution + timing for the
measured mode (the modeled mode uses simmpi.costmodel).
``studies`` builds the tuning studies at 'paper' and 'ci' scales.
"""

from .studies import (capital_cholesky_study, slate_cholesky_study,
                      candmc_qr_study, slate_qr_study, STUDIES)

__all__ = ["capital_cholesky_study", "slate_cholesky_study",
           "candmc_qr_study", "slate_qr_study", "STUDIES"]
