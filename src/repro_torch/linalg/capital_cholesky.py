"""Capital's recursive bulk-synchronous Cholesky on a 3D processor grid.

Paper §V.A: recursive application of

    [A11 A21^T; A21 A22] = [L11; L21 L22][L11^T L21^T; L22^T]

with the base case solved by sequential potrf/trtri once the subproblem
dimension falls below block size b.  Matrix products (L21 <- A21 L11^{-T},
S21, and the symmetric update A22 - L21 L21^T) execute as 3D-grid matmuls:
broadcasts along two grid dimensions, a reduction along the third, plus the
block-to-cyclic redistribution kernels the paper intercepts explicitly.

BSP cost (paper): Theta(alpha * n/b + beta * (n^2/p^{2/3} + n b)
                        + gamma * (n^3/p + n b^2)),
so latency wants a LARGE block size while bandwidth/compute want a SMALL
one — the non-trivial trade-off the autotuner must resolve.

Base-case strategies (paper's three):
  1. gather the base-case matrix onto one rank of one grid layer, factor,
     scatter across the layer, broadcast along the grid depth;
  2. all-gather within EVERY layer, factor redundantly everywhere;
  3. all-gather within ONE layer, factor redundantly across that layer,
     broadcast along the depth fiber.
"""

from __future__ import annotations

from repro_torch.simmpi import Coll, Comp
from repro_torch.simmpi.comm import World


def make_program(world: World, *, n: int, block: int, strategy: int,
                 grid_c: int):
    """Program factory for one (block size, base-case strategy) config.

    grid_c: cube edge — the processor grid is grid_c^3 = world.size.
    """
    assert grid_c ** 3 == world.size, (grid_c, world.size)
    assert strategy in (1, 2, 3)
    grids = world.grid_comms((grid_c, grid_c, grid_c))

    def program(rank: int, world: World):
        c = grid_c
        x, y, z = grids.coords(rank)
        row = grids.fiber(rank, 0)       # vary x: bcast dim
        col = grids.fiber(rank, 1)       # vary y: bcast dim
        depth = grids.fiber(rank, 2)     # vary z: reduce / replication dim
        layer = grids.slice(rank, (0, 1))  # the rank's c*c grid layer

        def matmul3d(m, nn, k, kind="gemm"):
            """3D matmul: bcast A along y, B along x, local product over the
            k/c slice owned by this layer, reduce C along z.  Local block
            dims are m/c x k/c etc. (cyclic layout keeps blocks square)."""
            mb, nb, kb = max(m // c, 1), max(nn // c, 1), max(k // c, 1)
            yield Comp("blk2cyc", (8 * mb * kb,))
            yield Coll("bcast", col, 8 * mb * kb)
            yield Coll("bcast", row, 8 * kb * nb)
            if kind == "gemm":
                yield Comp("gemm", (mb, nb, kb))
            elif kind == "trmm":
                yield Comp("trmm", (mb, nb))
            else:  # syrk-flavored update
                yield Comp("syrk", (mb, kb))
            yield Coll("reduce", depth, 8 * mb * nb)

        def base_case(b):
            """Factor the b x b base-case block: potrf + trtri (Capital
            tracks L^{-1} for its inverse-based recursion)."""
            blk = 8 * b * b
            if strategy == 1:
                if z == 0:
                    yield Coll("gather", layer, blk // layer.size)
                    if x == 0 and y == 0:
                        yield Comp("potrf", (b,))
                        yield Comp("trtri", (b,))
                    yield Coll("scatter", layer, blk // layer.size)
                yield Coll("bcast", depth, blk // layer.size)
            elif strategy == 2:
                yield Coll("allgather", layer, blk // layer.size)
                yield Comp("potrf", (b,))
                yield Comp("trtri", (b,))
            else:  # strategy 3
                if z == 0:
                    yield Coll("allgather", layer, blk // layer.size)
                    yield Comp("potrf", (b,))
                    yield Comp("trtri", (b,))
                yield Coll("bcast", depth, blk // layer.size)

        def chol(m):
            if m <= block:
                yield from base_case(m)
                return
            h = m // 2
            # A11 = L11 L11^T
            yield from chol(h)
            # L21 <- A21 L11^{-T}   (triangular product, 3D)
            yield from matmul3d(h, h, h, kind="trmm")
            # A22 <- A22 - L21 L21^T (symmetric rank-h update, 3D)
            yield from matmul3d(h, h, h, kind="syrk")
            # A22 = L22 L22^T
            yield from chol(h)
            # S21 <- -L22^{-1} L21 L11^{-1}  (two triangular products, 3D)
            yield from matmul3d(h, h, h, kind="trmm")
            yield from matmul3d(h, h, h, kind="trmm")

        yield from chol(n)

    return program
