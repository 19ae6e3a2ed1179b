"""Operations yielded by virtual-rank programs.

Programs are Python generators: ``def program(rank, world): yield <op>``.
Plain __slots__ classes (not dataclasses) — these sit on the hot path of the
event loop (hundreds of thousands of instances per simulated configuration).
"""

from __future__ import annotations

COLL_OPS = (
    "bcast", "reduce", "allreduce", "allgather", "gather", "scatter",
    "alltoall", "barrier",
)

# engine dispatch codes, one per op family.  The runtime dispatches on
# ``op.KIND`` (a small-int class attribute) rather than ``type(op) is X``
# identity, so user subclasses of the op classes (e.g. a Comp carrying
# extra bookkeeping) flow through the engine unchanged.
KIND_COMP, KIND_COLL, KIND_SEND, KIND_RECV, KIND_ISEND, KIND_WAIT = range(6)

# Compiled-program dispatch codes.  The recording pass lowers the op stream
# into three progressively specialized programs, each dispatching on the
# first element of its entry tuples (all defined here, next to the op-kind
# codes they descend from):
#
# EV_* — the flat event program emitted by the structural recording pass
#        (one entry per interception; comp runs fused into EV_BLOCKs);
# CS_* — the cold program: the event program re-sliced for batched forced
#        execution (static draw sequence, force-specialized interceptions);
# W_*  — the warm program (see core.critter): the event program segmented
#        at skip-decision and communication boundaries for the compiled
#        selective interpreter (per-rank comp segments batch-charge when
#        fully in the skip regime).  W_* codes live in core.critter next
#        to their interpreter — core must not import simmpi.
EV_COMP, EV_BLOCK, EV_COLL, EV_P2P, EV_IPOST, EV_IMATCH = range(6)
CS_COMP, CS_BLOCK, CS_IPOST, CS_COLL, CS_P2P, CS_IMATCH = range(6)


class Comp:
    """A local computation kernel: a routine with a particular input size.

    ``name``/``params`` identify the signature; ``flops`` may be provided
    explicitly, else it is derived analytically from the signature.

    ``sig_id`` is the runtime's interned-signature cache slot: ops live in
    replayable per-rank traces, so the dense id is resolved once per op
    instance and reused on every subsequent iteration (see
    ``simmpi.runtime``).
    """

    KIND = KIND_COMP
    __slots__ = ("name", "params", "flops", "sig_id")

    def __init__(self, name, params=(), flops=None):
        self.name = name
        self.params = tuple(params)
        self.flops = flops
        self.sig_id = None

    def __repr__(self):
        return f"Comp({self.name}{self.params})"


class Coll:
    """A blocking collective on a communicator."""

    KIND = KIND_COLL
    __slots__ = ("op", "comm", "nbytes", "root", "sig_id")

    def __init__(self, op, comm, nbytes, root=0):
        self.op = op
        self.comm = comm
        self.nbytes = int(nbytes)
        self.root = root
        self.sig_id = None

    def __repr__(self):
        return f"Coll({self.op}, p={self.comm.size}, {self.nbytes}B)"


def Barrier(comm):
    return Coll("barrier", comm, 0)


class Send:
    """Blocking (rendezvous) point-to-point send."""

    KIND = KIND_SEND
    __slots__ = ("dst", "nbytes", "tag", "sig_id")

    def __init__(self, dst, nbytes, tag=0):
        self.dst = int(dst)
        self.nbytes = int(nbytes)
        self.tag = tag
        self.sig_id = None

    def __repr__(self):
        return f"Send(->{self.dst}, {self.nbytes}B, tag={self.tag})"


class Recv:
    """Blocking point-to-point receive (matches Send or Isend)."""

    KIND = KIND_RECV
    __slots__ = ("src", "nbytes", "tag")

    def __init__(self, src, nbytes, tag=0):
        self.src = int(src)
        self.nbytes = int(nbytes)
        self.tag = tag

    def __repr__(self):
        return f"Recv(<-{self.src}, {self.nbytes}B, tag={self.tag})"


class Isend:
    """Nonblocking buffered send: deposits the message (with the sender's
    path profile snapshot) and completes locally.  Yields a request handle.

    Mirrors Figure 2's MPI_Isend interception: the internal message is sent
    with PMPI_Bsend so the sender never blocks; the execution decision is
    made from the sender's local state and travels with the message.
    """

    KIND = KIND_ISEND
    __slots__ = ("dst", "nbytes", "tag", "sig_id")

    def __init__(self, dst, nbytes, tag=0):
        self.dst = int(dst)
        self.nbytes = int(nbytes)
        self.tag = tag
        self.sig_id = None

    def __repr__(self):
        return f"Isend(->{self.dst}, {self.nbytes}B, tag={self.tag})"


class Wait:
    """Wait on a request handle returned by Isend (buffered => no-op cost,
    but the interception point exists, matching Figure 2's MPI_Wait)."""

    KIND = KIND_WAIT
    __slots__ = ("handle",)

    def __init__(self, handle):
        self.handle = handle

    def __repr__(self):
        return f"Wait({self.handle})"
