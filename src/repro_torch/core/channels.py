"""Cartesian communication channels and aggregate channels (paper §III.B).

A *channel* describes a sub-communicator as a strided subgrid of the world
communicator: an offset plus per-dimension (stride, size) pairs.  Channel
hash ids are generated purely from (stride, size) — offset-independent — so
that congruent sub-communicators (e.g. every row of a processor grid) share
one identity, which is what lets kernel statistics be aggregated across
symmetric grid slices.

*Aggregate channels* are recursively built unions of channels that span a
cartesian subgrid of the machine.  Once a kernel's statistics have been
propagated along a set of channels whose aggregate ``is_maximal`` (covers the
world communicator), every processor is known to hold the same statistics
and the kernel's execution can be switched off globally (eager propagation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def ranks_to_channel(ranks: Sequence[int]) -> Optional["Channel"]:
    """Recover a strided-cartesian description from a sorted rank list.

    Mirrors Critter's MPI_Comm_split interception: allgather world ranks,
    sort, then factor the rank set into (stride, size) dimensions.  Returns
    None if the rank set is not a cartesian (possibly multi-dimensional)
    strided grid — such communicators fall back to non-aggregating channels.
    """
    ranks = sorted(set(int(r) for r in ranks))
    if not ranks:
        return None
    offset = ranks[0]
    rel = [r - offset for r in ranks]
    dims: List[Tuple[int, int]] = []
    remaining = rel
    # Greedily peel the smallest stride: the gap between the first two ranks.
    while len(remaining) > 1:
        stride = remaining[1] - remaining[0]
        if stride <= 0:
            return None
        # size = how many consecutive multiples of stride are present
        size = 1
        while size < len(remaining) and remaining[size] == size * stride:
            size += 1
        if len(remaining) % size != 0:
            return None
        # verify remaining factors as blocks of this dimension
        nblocks = len(remaining) // size
        base: List[int] = []
        for b in range(nblocks):
            block = remaining[b * size:(b + 1) * size]
            start = block[0]
            for j, r in enumerate(block):
                if r != start + j * stride:
                    return None
            base.append(start)
        dims.append((stride, size))
        remaining = base
    return Channel(offset=offset, dims=tuple(dims) if dims else ((1, 1),))


@dataclass(frozen=True)
class Channel:
    """A strided cartesian subgrid of world ranks.

    dims is a tuple of (stride, size) pairs, innermost first.
    """

    offset: int
    dims: Tuple[Tuple[int, int], ...]

    @property
    def size(self) -> int:
        s = 1
        for _, sz in self.dims:
            s *= sz
        return s

    @property
    def hash_id(self) -> int:
        """Hash generated purely from (stride, size) pairs (Figure 2)."""
        h = 0x9E3779B97F4A7C15
        for stride, size in sorted(self.dims):
            h ^= (stride * 0x100000001B3 + size * 0x1B873593) & (2**64 - 1)
            h = (h * 0xC2B2AE3D27D4EB4F) & (2**64 - 1)
        return h

    def ranks(self) -> List[int]:
        out = [0]
        for stride, size in self.dims:
            out = [r + i * stride for i in range(size) for r in out]
        return sorted(self.offset + r for r in out)

    def key(self) -> Tuple[Tuple[int, int], ...]:
        """Offset-independent identity used for statistics aggregation."""
        return tuple(sorted(self.dims))


@dataclass
class Aggregate:
    """A recursively built union of channels spanning a cartesian subgrid."""

    dims: Tuple[Tuple[int, int], ...]       # combined (stride, size) pairs
    hash_id: int
    members: Tuple[int, ...]                # member channel hash ids
    is_maximal: bool = False

    @property
    def size(self) -> int:
        s = 1
        for _, sz in self.dims:
            s *= sz
        return s


class ChannelRegistry:
    """World-wide registry of channels and aggregate channels.

    The real Critter builds this identically on every rank from intercepted
    MPI_Comm_split calls; our simulator keeps one authoritative copy (the
    per-rank copies would be identical by construction).
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.channels: Dict[int, Channel] = {}
        self.aggregates: Dict[int, Aggregate] = {}
        # member-sets of world-spanning aggregates, precomputed so the
        # covers_world query on the eager hot path is a subset test per
        # covering set instead of a scan over every aggregate
        self._world_covers: List[frozenset] = []
        world = Channel(offset=0, dims=((1, world_size),))
        self.world_channel = world
        self.register(world)

    # -- registration (MPI_Init / MPI_Comm_split interception) -------------

    def register(self, channel: Channel) -> Channel:
        h = channel.hash_id
        if h not in self.channels:
            self.channels[h] = channel
            self._build_aggregates(channel)
        return channel

    def register_ranks(self, ranks: Sequence[int]) -> Optional[Channel]:
        ch = ranks_to_channel(ranks)
        if ch is not None:
            self.register(ch)
        return ch

    def _disjoint(self, a: Tuple[Tuple[int, int], ...],
                  b: Tuple[Tuple[int, int], ...]) -> bool:
        """Two dim-sets combine into a cartesian grid iff, sorted by stride,
        each dimension's stride is a multiple of (and at least) the previous
        dimension's span — every rank combination is then distinct and the
        union is a strided cartesian subgrid."""
        merged = sorted(a + b)
        span = 1
        for stride, size in merged:
            if stride < span or stride % span != 0:
                return False
            span = stride * size
        return span <= self.world_size

    def _build_aggregates(self, channel: Channel) -> None:
        """Recursively combine the new channel with existing aggregates
        (Figure 2, MPI_Comm_split interception)."""
        base = Aggregate(dims=tuple(sorted(channel.dims)),
                         hash_id=channel.hash_id,
                         members=(channel.hash_id,),
                         is_maximal=(channel.size == self.world_size))
        if base.hash_id not in self.aggregates:
            self.aggregates[base.hash_id] = base
            if base.size == self.world_size:
                self._world_covers.append(frozenset(base.members))
        frontier = [base]
        while frontier:
            nxt: List[Aggregate] = []
            for agg in frontier:
                for other in list(self.aggregates.values()):
                    if agg.hash_id == other.hash_id:
                        continue
                    if set(agg.members) & set(other.members):
                        continue
                    dims = tuple(sorted(agg.dims + other.dims))
                    if not self._disjoint(agg.dims, other.dims):
                        continue
                    new_hash = agg.hash_id ^ other.hash_id
                    if new_hash in self.aggregates:
                        continue
                    size = 1
                    for _, sz in dims:
                        size *= sz
                    if size > self.world_size:
                        continue
                    new = Aggregate(
                        dims=dims, hash_id=new_hash,
                        members=tuple(sorted(agg.members + other.members)),
                        is_maximal=(size == self.world_size))
                    if new.is_maximal:
                        # combining into the full machine demotes maximality
                        # of strict sub-aggregates (Figure 2: is_maximal=false)
                        for m in (agg, other):
                            if m.size < self.world_size:
                                m.is_maximal = False
                    self.aggregates[new_hash] = new
                    if new.size == self.world_size:
                        self._world_covers.append(frozenset(new.members))
                    nxt.append(new)
            frontier = nxt

    # -- queries ------------------------------------------------------------

    def covers_world(self, channel_hashes: set) -> bool:
        """True if some registered aggregate built solely from the given
        channel hashes spans the world communicator — i.e. a kernel whose
        statistics were propagated along these channels is globally agreed."""
        for members in self._world_covers:
            if members <= channel_hashes:
                return True
        return False
