"""SLATE's task-based tile Cholesky on a 2D processor grid.

Paper §V.A: the matrix is partitioned into tiles of tunable size on a 2D
block-cyclic grid; each tile maintains a predecessor list (trsm and syrk/gemm
updates) and tasks execute as dependencies resolve, with *lookahead
pipelining* of tunable depth prioritizing the tasks the next panel
factorization depends on.  Scheduling uses nonblocking point-to-point
communication (isend/recv), which is how SLATE reduces synchronization
overhead — and why the paper's nonblocking interception path (Figure 2
MPI_Isend / MPI_Wait) is exercised by this study.

Kernel mix: potrf(t), trsm(t), syrk(t), gemm(t) at a FIXED tile size per
configuration — the frequently-recurring same-input-size kernels for which
the paper observes up to 75x reduction in kernel execution time.
"""

from __future__ import annotations

from repro_torch.simmpi import Comp, Isend, Recv, Wait
from repro_torch.simmpi.comm import World


def make_program(world: World, *, n: int, tile: int, lookahead: int,
                 pr: int, pc: int):
    assert pr * pc == world.size
    nt = n // tile
    tb = 8 * tile * tile  # bytes per tile

    def owner(i, j):
        return (i % pr) + pr * (j % pc)

    def program(rank: int, world: World):
        myrow, mycol = rank % pr, rank // pr
        TAG_LKK, TAG_ROW, TAG_COL = 0, 1, 2

        # Ownership is block-cyclic, so "the tiles of column j this rank
        # owns" is the arithmetic progression i ≡ myrow (mod pr), and "the
        # distinct owners of a tile range, in first-touch order" is just
        # the first min(pr, len) (resp. pc) elements of the range: the
        # generators below enumerate these directly instead of scanning
        # every tile and filtering by owner(), which dominated the cold
        # (recording) run's generator cost.  The yielded op stream is
        # bit-identical to the scan-and-filter form (pinned by
        # tests/test_cold_path.py against a reference implementation).

        def my_rows(lo):
            """Rows i >= lo with i ≡ myrow (mod pr), ascending."""
            return range(lo + ((myrow - lo) % pr), nt, pr)

        def panel(k):
            """potrf(k,k) + column-k trsms, with the factored tiles
            broadcast row-wise (for row-i updates) and the transposed
            panel broadcast column-wise (for the L_jk^T operands)."""
            kcol = pr * (k % pc)
            if k % pr == myrow and k % pc == mycol:   # owner(k, k) == rank
                yield Comp("potrf", (tile,))
                # send L_kk down grid column (k % pc) to the trsm owners:
                # distinct owners appear within the first pr rows below k
                for i in range(k + 1, min(k + 1 + pr, nt)):
                    o = (i % pr) + kcol
                    if o != rank:
                        yield Isend(o, tb, (TAG_LKK, k))
            # trsm for owned tiles (i, k), i > k
            if k % pc != mycol:
                return
            my_tiles = my_rows(k + 1)
            if my_tiles and k % pr != myrow:
                yield Recv((k % pr) + kcol, tb, (TAG_LKK, k))
            for i in my_tiles:
                yield Comp("trsm", (tile, tile))
                # row-wise: L_ik to ranks in my grid row owning (i, j>k)
                for j in range(k + 1, min(k + 1 + pc, i + 1)):
                    o = myrow + pr * (j % pc)
                    if o != rank:
                        yield Isend(o, tb, (TAG_ROW, k, i))
                # column-wise: L_ik^T to ranks owning (i' > i, i)
                icol = pr * (i % pc)
                for i2 in range(i, min(i + pr, nt)):
                    o = (i2 % pr) + icol
                    if o != rank:
                        yield Isend(o, tb, (TAG_COL, k, i))

        def recv_for_update(k, i, j, got):
            """Receive the L_ik (row operand) and L_jk (col operand) this
            rank needs for tile (i, j), once per source tile."""
            src_row = owner(i, k)
            if ("r", i) not in got:
                got.add(("r", i))
                if src_row != rank:
                    yield Recv(src_row, tb, (TAG_ROW, k, i))
            src_col = owner(j, k)
            if ("c", j) not in got:
                got.add(("c", j))
                if src_col != rank:
                    yield Recv(src_col, tb, (TAG_COL, k, j))

        def updates(k, js, got):
            """Trailing updates from panel k for tile-columns js."""
            for j in js:
                if j % pc != mycol:
                    continue
                for i in my_rows(j):
                    yield from recv_for_update(k, i, j, got)
                    if i == j:
                        yield Comp("syrk", (tile, tile))
                    else:
                        yield Comp("gemm", (tile, tile, tile))

        # main loop with lookahead: after panel k, the updates feeding the
        # next `lookahead` panels run first so panel k+1 can start before
        # the rest of panel k's trailing matrix is updated.
        deferred = []   # (k, far_columns, got-set)
        for k in range(nt):
            # flush deferred far updates whose lookahead window has passed
            while deferred and deferred[0][0] < k - lookahead:
                dk, djs, dgot = deferred.pop(0)
                yield from updates(dk, djs, dgot)
            yield from panel(k)
            got = set()
            if lookahead > 0:
                near = [j for j in range(k + 1, min(k + 1 + lookahead, nt))]
                far = [j for j in range(k + 1 + lookahead, nt)]
                yield from updates(k, near, got)
                if far:
                    deferred.append((k, far, got))
            else:
                yield from updates(k, list(range(k + 1, nt)), got)
        for dk, djs, dgot in deferred:
            yield from updates(dk, djs, dgot)

    return program
