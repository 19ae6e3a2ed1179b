"""Per-rank pathsets and kernel sets, stored struct-of-arrays.

Each processor owns (paper §III.B):

- ``K-bar``   — performance statistics for each locally-executed kernel;
- ``K-tilde`` — per-kernel info along its *current sub-critical path*
                (execution counts/frequencies, propagation bookkeeping);
- pathset ``P`` — the accumulated cost metrics of the rank's current
                sub-critical path (exec time, and the breakdown into
                computation / communication time used by the paper's
                critical-path metrics).

The seed implementation kept one object per rank holding dict-of-Signature
tables; this rewrite stores everything as NumPy struct-of-arrays indexed by
``(rank, signature id)`` (see ``core.signatures.SignatureInterner``), so

- the internal allreduce at collectives (max-path winner, clock sync,
  critical-path count adoption) is a vectorized reduction over participant
  index arrays instead of a Python loop over ranks x kernels, and
- ``report()`` is a handful of array reductions.

Path-profile quantities (``path_*``: exec/comp/comm time estimates) travel
with the longest-path adoption protocol; *physical* quantities — the
wall-clock the rank actually spends under selective execution (``clock``)
and the time it spends really executing kernels (``measured_*``) — are
per-rank and are never adopted.  K-bar keeps one ``KernelStats`` object per
(rank, sid) — Welford merge/copy semantics live there — with the sample
mean mirrored into ``mean_arr`` so skip-path predictions vectorize.
"""

from __future__ import annotations

import math
from typing import Dict, List, Set

import numpy as np

from .stats import KernelStats


class EngineState:
    """All Critter state for all ranks, struct-of-arrays.

    Column capacity grows on demand as new signature ids are interned; rows
    are fixed at the world size.  ``seen[r, s]`` marks membership of sid
    ``s`` in rank ``r``'s K-tilde (the seed kept dict keys for this), which
    the count-adoption protocol needs: a dominated rank adopts the winner's
    counts only for kernels *the winner has seen*, keeping its own counts
    for the rest.

    Forced-run liveness contract (the batched cold path relies on this —
    see ``Critter.on_comp_cold``/``finish_cold``): during a forced run,
    ``freq`` and ``seen`` are read mid-run (Isend snapshots, count
    adoption) and must be written per event, while ``iter_exec``,
    ``mean_arr`` and ``skip_ok`` are only consumed by the selective vote
    and skip-prediction paths — never under force — so cold interceptions
    may defer them to one bulk pass at the end of the run (``iter_exec``,
    ``mean_arr``) or elide no-op writes entirely (``skip_ok``, all-False
    after ``reset_iteration`` and never set under force).
    """

    __slots__ = ("n_ranks", "cap", "clock", "path_exec", "path_comp",
                 "path_comm", "path_kernels", "measured_time",
                 "measured_comp", "executed", "skipped", "freq", "seen",
                 "iter_exec", "mean_arr", "skip_ok", "goff", "gmean",
                 "kbar", "agg_channels", "pred_live")

    def __init__(self, n_ranks: int, cap: int = 256):
        self.n_ranks = n_ranks
        self.cap = cap
        # per-rank scalars ---------------------------------------------------
        self.clock = np.zeros(n_ranks)
        self.path_exec = np.zeros(n_ranks)
        self.path_comp = np.zeros(n_ranks)
        self.path_comm = np.zeros(n_ranks)
        self.path_kernels = np.zeros(n_ranks, dtype=np.int64)
        self.measured_time = np.zeros(n_ranks)
        self.measured_comp = np.zeros(n_ranks)
        self.executed = np.zeros(n_ranks, dtype=np.int64)
        self.skipped = np.zeros(n_ranks, dtype=np.int64)
        # per (rank, sid) ----------------------------------------------------
        self.freq = np.zeros((n_ranks, cap), dtype=np.int64)
        self.seen = np.zeros((n_ranks, cap), dtype=bool)
        self.iter_exec = np.zeros((n_ranks, cap), dtype=bool)
        # mirror of kbar[r][sid].mean (NaN when absent or n == 0)
        self.mean_arr = np.full((n_ranks, cap), math.nan)
        # memoized skip verdicts: True means "this rank's local execute vote
        # for sid is SKIP, proven at critical-path count 1" — such verdicts
        # are immune to count adoption (relative CI only shrinks with freq)
        # and stay valid until the (rank, sid) statistics change or the
        # iteration ends (see Critter._skip_verdict)
        self.skip_ok = np.zeros((n_ranks, cap), dtype=bool)
        # eager global switch-off, array form (mirrors Critter.global_off):
        # goff[sid] + the globally-agreed mean for switched-off kernels
        self.goff = np.zeros(cap, dtype=bool)
        self.gmean = np.full(cap, math.nan)
        # K-bar: Welford statistics objects, dict-of-int per rank
        self.kbar: List[Dict[int, KernelStats]] = \
            [dict() for _ in range(n_ranks)]
        # K[i].agg_channels: channel hashes a kernel's statistics have been
        # propagated along (eager), per rank {sid: set-of-hash}
        self.agg_channels: List[Dict[int, Set[int]]] = \
            [dict() for _ in range(n_ranks)]
        # eager-only dirty set: sids whose CURRENT statistics on this rank
        # are predictable at critical-path count 1 — exactly the candidate
        # precondition of aggregate_statistics, maintained incrementally at
        # every statistics write so the per-collective scan touches only
        # these instead of walking the whole K-bar (sids already switched
        # off globally are filtered lazily during the scan)
        self.pred_live: List[Set[int]] = [set() for _ in range(n_ranks)]

    # -- capacity ------------------------------------------------------------

    def ensure(self, sid: int) -> None:
        """Grow column capacity to cover ``sid``."""
        if sid < self.cap:
            return
        new_cap = max(self.cap * 2, sid + 1)
        pad = new_cap - self.cap
        self.freq = np.pad(self.freq, ((0, 0), (0, pad)))
        self.seen = np.pad(self.seen, ((0, 0), (0, pad)))
        self.iter_exec = np.pad(self.iter_exec, ((0, 0), (0, pad)))
        self.mean_arr = np.pad(self.mean_arr, ((0, 0), (0, pad)),
                               constant_values=math.nan)
        self.skip_ok = np.pad(self.skip_ok, ((0, 0), (0, pad)))
        self.goff = np.pad(self.goff, (0, pad))
        self.gmean = np.pad(self.gmean, (0, pad), constant_values=math.nan)
        self.cap = new_cap

    # -- resets --------------------------------------------------------------

    def reset_iteration(self) -> None:
        """Reset per-iteration path state (start of a configuration run);
        K-tilde membership, statistics and propagation sets persist."""
        self.clock.fill(0.0)
        self.path_exec.fill(0.0)
        self.path_comp.fill(0.0)
        self.path_comm.fill(0.0)
        self.path_kernels.fill(0)
        self.measured_time.fill(0.0)
        self.measured_comp.fill(0.0)
        self.executed.fill(0)
        self.skipped.fill(0)
        self.freq.fill(0)
        self.iter_exec.fill(False)
        self.skip_ok.fill(False)

    def reset_models(self) -> None:
        """Forget all kernel statistics (paper: 'we reset the performance
        statistics of all kernels before tuning a new configuration')."""
        for d in self.kbar:
            d.clear()
        for d in self.agg_channels:
            d.clear()
        for s in self.pred_live:
            s.clear()
        self.seen.fill(False)
        self.freq.fill(0)
        self.mean_arr.fill(math.nan)
        self.skip_ok.fill(False)
        self.goff.fill(False)
        self.gmean.fill(math.nan)

    # -- K-bar helpers -------------------------------------------------------

    def stats(self, rank: int, sid: int) -> KernelStats:
        d = self.kbar[rank]
        st = d.get(sid)
        if st is None:
            st = d[sid] = KernelStats()
        return st


class ColdScalars:
    """List-backed mirrors of the per-rank scalar timers for the duration
    of one forced (cold) run.

    The cold interpreter's interceptions are dominated by scalar reads and
    read-modify-writes of the per-rank accumulators (clock, path profile,
    measured time, counters) — on the p2p-heavy programs two ranks per
    event, several fields each.  NumPy scalar indexing pays boxing/unboxing
    per access; plain Python lists of floats/ints are several times
    cheaper, and the arithmetic (IEEE double adds, int increments, max of
    two floats) is value-identical.  ``Critter.begin_cold`` snapshots the
    arrays into lists, the ``*_cold`` interceptions operate on them, and
    ``finish_cold`` writes them back — nothing else reads the per-rank
    scalars mid-forced-run (the selective vote and skip-prediction paths
    never run under force).  ``skipped`` is untouched by forced runs and
    stays on the array.
    """

    __slots__ = ("clock", "path_exec", "path_comp", "path_comm",
                 "path_kernels", "measured_time", "measured_comp",
                 "executed")

    def __init__(self, S: EngineState):
        self.clock = S.clock.tolist()
        self.path_exec = S.path_exec.tolist()
        self.path_comp = S.path_comp.tolist()
        self.path_comm = S.path_comm.tolist()
        self.path_kernels = S.path_kernels.tolist()
        self.measured_time = S.measured_time.tolist()
        self.measured_comp = S.measured_comp.tolist()
        self.executed = S.executed.tolist()

    def writeback(self, S: EngineState) -> None:
        S.clock[:] = self.clock
        S.path_exec[:] = self.path_exec
        S.path_comp[:] = self.path_comp
        S.path_comm[:] = self.path_comm
        S.path_kernels[:] = self.path_kernels
        S.measured_time[:] = self.measured_time
        S.measured_comp[:] = self.measured_comp
        S.executed[:] = self.executed


class WarmMirror:
    """List-backed mirrors of the full engine state for one compiled
    (warm, selective) replay — ``ColdScalars`` extended to the per-
    (rank, sid) tables.

    The compiled warm interpreter (``Critter.run_warm``) is dominated by
    scalar reads of ``skip_ok``/``mean_arr``/``goff``/``gmean`` and scalar
    read-modify-writes of ``freq``/``seen`` and the per-rank accumulators;
    Python lists make each of those several times cheaper than NumPy
    scalar indexing while keeping the arithmetic value-identical (IEEE
    double adds, int increments, bool stores).  Rows are truncated to
    ``nlive`` — the number of interned signatures when the replay starts —
    which covers every sid the recorded program can touch; columns at or
    beyond ``nlive`` are provably untouched and keep their array values.

    ``goff``/``gmean`` are read-only snapshots refreshed by the caller
    after eager aggregation (which writes the arrays directly); they are
    not written back.
    """

    __slots__ = ("nlive", "clock", "path_exec", "path_comp", "path_comm",
                 "path_kernels", "measured_time", "measured_comp",
                 "executed", "skipped", "freq", "seen", "iter_exec",
                 "mean", "skip_ok", "goff", "gmean")

    def __init__(self, S: EngineState, nlive: int):
        self.nlive = nlive
        self.clock = S.clock.tolist()
        self.path_exec = S.path_exec.tolist()
        self.path_comp = S.path_comp.tolist()
        self.path_comm = S.path_comm.tolist()
        self.path_kernels = S.path_kernels.tolist()
        self.measured_time = S.measured_time.tolist()
        self.measured_comp = S.measured_comp.tolist()
        self.executed = S.executed.tolist()
        self.skipped = S.skipped.tolist()
        self.freq = S.freq[:, :nlive].tolist()
        self.seen = S.seen[:, :nlive].tolist()
        self.iter_exec = S.iter_exec[:, :nlive].tolist()
        self.mean = S.mean_arr[:, :nlive].tolist()
        self.skip_ok = S.skip_ok[:, :nlive].tolist()
        self.goff = S.goff[:nlive].tolist()
        self.gmean = S.gmean[:nlive].tolist()

    def pull_rank(self, S: EngineState, r: int) -> None:
        """Re-snapshot one rank's prediction rows after an external write
        (eager aggregation updates ``mean_arr``/``skip_ok`` in place)."""
        n = self.nlive
        self.mean[r] = S.mean_arr[r, :n].tolist()
        self.skip_ok[r] = S.skip_ok[r, :n].tolist()

    def pull_global(self, S: EngineState) -> None:
        n = self.nlive
        self.goff = S.goff[:n].tolist()
        self.gmean = S.gmean[:n].tolist()

    def push_rank(self, S: EngineState, r: int) -> None:
        """Write one rank's rows back before an external reader (eager
        aggregation reads ``mean_arr`` via KernelStats, and writes must
        land on current values)."""
        n = self.nlive
        if n:
            S.mean_arr[r, :n] = self.mean[r]
            S.skip_ok[r, :n] = self.skip_ok[r]

    def writeback(self, S: EngineState) -> None:
        S.clock[:] = self.clock
        S.path_exec[:] = self.path_exec
        S.path_comp[:] = self.path_comp
        S.path_comm[:] = self.path_comm
        S.path_kernels[:] = self.path_kernels
        S.measured_time[:] = self.measured_time
        S.measured_comp[:] = self.measured_comp
        S.executed[:] = self.executed
        S.skipped[:] = self.skipped
        n = self.nlive
        if n:
            S.freq[:, :n] = self.freq
            S.seen[:, :n] = self.seen
            S.iter_exec[:, :n] = self.iter_exec
            S.mean_arr[:, :n] = self.mean
            S.skip_ok[:, :n] = self.skip_ok
