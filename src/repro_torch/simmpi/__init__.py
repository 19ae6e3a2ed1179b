"""simmpi — a discrete-event, virtual-rank MPI runtime.

The paper's mechanism (Figure 2) is a PMPI interposer: every MPI call is
intercepted, an internal message carrying ``(exec_time, keys, freqs,
execute)`` is exchanged among the participants, the longest sub-critical
path wins, and the *user* communication is then executed selectively.

There is no PMPI on TPU and JAX programs are compiled SPMD programs, so we
re-host the identical protocol inside a discrete-event simulator: each
virtual rank runs a Python generator program that yields computation and
communication kernels; the runtime matches communications, advances
per-rank clocks, and invokes the Critter interception logic at exactly the
points the real tool would.  The update rules executed at each interception
are those of Figure 2, verbatim (max-path adoption, OR'd execute votes,
winner's kernel frequencies adopted).
"""

from .ops import Comp, Coll, Send, Recv, Isend, Wait, Barrier
from .comm import Comm, World
from .costmodel import CostModel, MachineSpec, KNL_STAMPEDE2, TPU_V5E
from .runtime import Runtime, RunResult, DeadlockError

__all__ = [
    "Comp", "Coll", "Send", "Recv", "Isend", "Wait", "Barrier",
    "Comm", "World",
    "CostModel", "MachineSpec", "KNL_STAMPEDE2", "TPU_V5E",
    "Runtime", "RunResult", "DeadlockError",
]
