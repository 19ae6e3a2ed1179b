"""Communicators over virtual ranks.

A communicator is a subset of world ranks.  On creation it is factored into
a strided-cartesian *channel* (offset + (stride, size) dims) exactly the way
Critter's MPI_Comm_split interception does (allgather world ranks, sort,
factor) — the channel identity (stride/size only, offset-independent) is
what kernel signatures and the aggregate-channel machinery key on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channels import Channel, ChannelRegistry, ranks_to_channel
from repro_torch.core.signatures import SignatureInterner


class Comm:
    __slots__ = ("id", "ranks", "ranks_np", "world", "channel", "_index",
                 "_arrivals", "stride", "size")

    _next_id = 0

    def __init__(self, world: "World", ranks: Sequence[int]):
        self.id = Comm._next_id
        Comm._next_id += 1
        self.world = world
        self.ranks: Tuple[int, ...] = tuple(sorted(int(r) for r in ranks))
        # participant index array for the engine's vectorized reductions
        self.ranks_np = np.array(self.ranks, dtype=np.intp)
        self.size = len(self.ranks)
        self._index: Dict[int, int] = {r: i for i, r in enumerate(self.ranks)}
        # channel factorization (None for non-cartesian rank sets)
        self.channel: Optional[Channel] = world.registry.register_ranks(self.ranks)
        # representative stride for signatures: innermost dim stride, 0 if
        # non-cartesian (paper: comm kernels parameterized on size + stride)
        self.stride = self.channel.dims[0][0] if self.channel else 0
        # per-collective-site arrival bookkeeping (runtime internal)
        self._arrivals = {}

    def rank_index(self, world_rank: int) -> int:
        return self._index[world_rank]

    def translate(self, comm_rank: int) -> int:
        """comm-local rank -> world rank."""
        return self.ranks[comm_rank]

    def __contains__(self, world_rank: int) -> bool:
        return world_rank in self._index

    def __repr__(self):
        return f"Comm(id={self.id}, size={self.size}, stride={self.stride})"


class World:
    """The world communicator plus a registry of sub-communicators.

    Sub-communicator creation mirrors MPI_Comm_split: the caller provides
    the rank sets; the channel registry builds aggregate channels from their
    cartesian factorizations (Figure 2, MPI_Comm_split interception).
    """

    def __init__(self, size: int):
        self.size = size
        self.registry = ChannelRegistry(size)
        # world-scoped signature id space: ids stay dense per study, so the
        # engine's per-(rank, sid) tables are sized by THIS world's kernel
        # count rather than every signature ever interned in the process
        self.interner = SignatureInterner()
        self.world_comm = Comm(self, range(size))
        self._comms: Dict[Tuple[int, ...], Comm] = {
            self.world_comm.ranks: self.world_comm}

    def comm(self, ranks: Sequence[int]) -> Comm:
        """Get-or-create the communicator over the given world ranks."""
        key = tuple(sorted(int(r) for r in ranks))
        c = self._comms.get(key)
        if c is None:
            c = Comm(self, key)
            self._comms[key] = c
        return c

    # -- cartesian-grid helpers (what the linalg schedules use) -------------

    def grid_comms(self, dims: Sequence[int]) -> "GridComms":
        return GridComms(self, dims)


class GridComms:
    """Row/column/fiber communicators of a cartesian processor grid.

    Ranks are mapped to grid coordinates in row-major order with dim 0
    innermost (fastest-varying), so a fiber along dim 0 is a stride-1
    communicator, along dim 1 a stride-dims[0] communicator, etc. — the
    strided channels the paper's aggregate machinery is built for.
    """

    def __init__(self, world: World, dims: Sequence[int]):
        self.world = world
        self.dims = tuple(int(d) for d in dims)
        n = 1
        for d in self.dims:
            n *= d
        if n != world.size:
            raise ValueError(f"grid {self.dims} != world size {world.size}")
        self.strides = []
        s = 1
        for d in self.dims:
            self.strides.append(s)
            s *= d

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for d, s in zip(self.dims, self.strides):
            out.append((rank // s) % d)
        return tuple(out)

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.strides):
            r += c * s
        return r

    def fiber(self, rank: int, dim: int) -> Comm:
        """Communicator of all ranks sharing every coordinate of ``rank``
        except along ``dim`` (an MPI_Comm_split by the other coords)."""
        base = self.coords(rank)
        ranks = []
        for i in range(self.dims[dim]):
            c = list(base)
            c[dim] = i
            ranks.append(self.rank_of(c))
        return self.world.comm(ranks)

    def slice(self, rank: int, dims: Sequence[int]) -> Comm:
        """Communicator of all ranks sharing the coordinates of ``rank``
        along every dimension NOT in ``dims`` (a multi-dim slab)."""
        base = self.coords(rank)
        free = list(dims)
        ranks = []

        def rec(i, cur):
            if i == len(free):
                ranks.append(self.rank_of(cur))
                return
            d = free[i]
            for v in range(self.dims[d]):
                nxt = list(cur)
                nxt[d] = v
                rec(i + 1, nxt)

        rec(0, list(base))
        return self.world.comm(ranks)
