"""CANDMC's pipelined bulk-synchronous 2D Householder QR.

Paper §V.B: panels of width b are factorized with TSQR (local geqrf + a
binary-tree reduction of stacked triangles via tpqrt), the compact
Householder representation Y,T is reconstructed (LU-based, emitted here as
the trtri/gemm/ormqr mix CANDMC invokes), Y is broadcast row-wise, and the
trailing matrix update W = (TY)^T A / A -= Y W runs with a column all-reduce.

BSP cost: Theta(alpha * n/b + beta * (mn/p_r + n^2/p_c + nb)
                + gamma * (mn^2/p + nb^2 + mnb/p_r + n^2 b/p_c)),
making performance highly sensitive to BOTH the block size b and the grid
(p_r x p_c) — the paper's configuration space sweeps both.

Lookahead pipelining: the grid column that owns the next panel performs its
slice of the trailing update first and proceeds into the next panel's TSQR
while the other columns finish the wide update (§V.B).

The trailing matrix shrinks every panel, so gemm/ormqr signatures take many
DISTINCT input sizes — the regime where per-signature modeling pays off
least (paper: overall speedup limited to 1.2x) and the beyond-paper
extrapolation model pays off most.
"""

from __future__ import annotations

from repro_torch.simmpi import Coll, Comp, Recv, Send
from repro_torch.simmpi.comm import World


def make_program(world: World, *, m: int, n: int, block: int,
                 pr: int, pc: int):
    assert pr * pc == world.size
    npan = n // block
    b = block

    def program(rank: int, world: World):
        grids = world.grid_comms((pr, pc))
        myrow, mycol = grids.coords(rank)
        rowc = grids.fiber(rank, 1)   # ranks sharing my grid row (size pc)
        colc = grids.fiber(rank, 0)   # ranks sharing my grid column (size pr)

        def tsqr(m_loc):
            """TSQR over the grid column: local geqrf, then a binary
            exchange tree of stacked-triangle factorizations."""
            yield Comp("geqrf", (max(m_loc, b), b))
            step = 1
            while step < pr:
                partner_row = myrow ^ step
                if partner_row < pr:
                    partner = grids.rank_of((partner_row, mycol))
                    nbytes = 8 * b * b // 2
                    if myrow < partner_row:
                        yield Send(partner, nbytes, ("tsqr", step))
                        yield Recv(partner, nbytes, ("tsqr", step))
                    else:
                        yield Recv(partner, nbytes, ("tsqr", step))
                        yield Send(partner, nbytes, ("tsqr", step))
                    yield Comp("tpqrt", (2 * b, b))
                step *= 2

        def reconstruct(m_loc):
            """Householder reconstruction: Y1 via LU of a Q1-derived matrix
            (ormqr to apply Q, trtri + small gemms for the T factor)."""
            yield Comp("ormqr", (max(m_loc, b), b, b))
            yield Comp("trtri", (b,))
            yield Comp("gemm", (b, b, b))
            yield Coll("bcast", colc, 8 * b * b)

        for j in range(npan):
            m_loc = max((m - j * b) // pr, b)
            n_loc = max((n - (j + 1) * b) // pc, 0)
            panel_col = j % pc

            if mycol == panel_col:
                yield from tsqr(m_loc)
                yield from reconstruct(m_loc)

            if n_loc > 0:
                # broadcast Y panel row-wise from the factorizing column
                yield Coll("bcast", rowc, 8 * m_loc * b)
                # W = (T Y)^T A_loc, reduced over the grid column
                yield Comp("gemm", (b, n_loc, m_loc))
                yield Coll("allreduce", colc, 8 * b * n_loc)
                yield Comp("trmm", (b, n_loc))
                # A_loc -= Y W
                yield Comp("gemm", (m_loc, n_loc, b))

    return program
