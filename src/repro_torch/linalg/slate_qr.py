"""SLATE's task-based 2D Householder QR with internally-blocked panels.

Paper §V.B: block-cyclic tiles on a 2D grid, task-based scheduling via
nonblocking p2p (isend/send/recv).  The panel factorization is internally
blocked with parameter w (< tile size) "to increase thread concurrency" —
each panel-tile task issues tile/w internally-blocked geqrf/tpqrt calls.
Trailing updates apply the block reflectors tile-by-tile (trmm + tpmqrt +
gemm; the BLAS-2 work inside the panel is NOT executed selectively, per
§V.D, and is emitted here as non-interceptable overhead baked into the
geqrf kernels).

Configuration space: inner width w x panel (tile) width x processor grid —
63 configurations in the paper.
"""

from __future__ import annotations

from repro_torch.simmpi import Comp, Isend, Recv
from repro_torch.simmpi.comm import World


def make_program(world: World, *, m: int, n: int, tile: int, inner: int,
                 pr: int, pc: int):
    assert pr * pc == world.size
    mt, nt = m // tile, n // tile
    w = max(min(inner, tile), 1)
    chunks = max(tile // w, 1)
    tb = 8 * tile * tile

    def owner(i, j):
        return (i % pr) + pr * (j % pc)

    def program(rank: int, world: World):
        TAG_CHAIN, TAG_V, TAG_T = 0, 1, 2

        for k in range(nt):
            # ---- panel factorization: triangle-reduction chain down the
            # tile column, internally blocked by w ----
            prev = None
            col_owners = []
            for i in range(k, mt):
                o = owner(i, k)
                if not col_owners or col_owners[-1] != o:
                    col_owners.append(o)
            if owner(k, k) == rank:
                for _ in range(chunks):
                    yield Comp("geqrf", (tile, w))
            # chain: each distinct owner folds its tiles into the triangle
            # received from the previous owner in the column
            for ci, o in enumerate(col_owners):
                if o != rank:
                    continue
                if ci > 0:
                    yield Recv(col_owners[ci - 1], 8 * tile * tile // 2,
                               (TAG_CHAIN, k, ci))
                my_tiles = [i for i in range(k, mt)
                            if owner(i, k) == rank and (i > k or ci > 0)]
                for _ in my_tiles:
                    for _ in range(chunks):
                        yield Comp("tpqrt", (tile, w))
                if ci + 1 < len(col_owners):
                    yield Isend(col_owners[ci + 1], 8 * tile * tile // 2,
                                (TAG_CHAIN, k, ci + 1))

            # ---- broadcast reflectors row-wise: each panel-tile owner
            # sends (V_i, T_i) to the ranks of its grid row that own
            # trailing tiles ----
            for i in range(k, mt):
                if owner(i, k) != rank:
                    continue
                sent = set()
                for j in range(k + 1, nt):
                    o = owner(i, j)
                    if o != rank and o not in sent:
                        sent.add(o)
                        yield Isend(o, tb, (TAG_V, k, i))

            # ---- trailing update: row k tiles get trmm+gemm, lower tiles
            # get the internally-blocked tpmqrt ----
            got = set()   # per-panel: each (V_i, T_i) is received once
            for j in range(k + 1, nt):
                for i in range(k, mt):
                    if owner(i, j) != rank:
                        continue
                    src = owner(i, k)
                    if src != rank and (k, i) not in got:
                        got.add((k, i))
                        yield Recv(src, tb, (TAG_V, k, i))
                    if i == k:
                        yield Comp("trmm", (tile, tile))
                        yield Comp("gemm", (tile, tile, tile))
                    else:
                        for _ in range(chunks):
                            yield Comp("tpmqrt", (tile, tile, w))

    return program
