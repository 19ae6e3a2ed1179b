"""Critter: the paper's online selective-execution profiler.

This module implements the interception protocol of Figure 2 — the logic the
real tool runs inside PMPI wrappers — as methods invoked by the simmpi
runtime at each kernel event:

- ``on_comp``  — local computation kernel (BLAS/LAPACK interception);
- ``on_coll``  — blocking collective (MPI_Bcast et al. interception):
  internal allreduce of (exec_time, execute-vote, keys, freqs), max-path
  winner adoption, selective execution, ``update_statistics`` and — for
  eager propagation — ``aggregate_statistics`` across the channel;
- ``on_p2p``   — blocking Send/Recv (MPI_Recv interception: internal
  PMPI_Sendrecv, max of the two paths, OR of execute votes);
- ``on_isend_post`` / ``on_isend_match`` — nonblocking p2p (MPI_Isend /
  MPI_Wait interception: decision made from sender-local state, statistics
  updated at completion).

The five selective-execution policies of §IV.B are parameterized by
``core.policies.Policy``; the aggregate-channel closure used by eager
propagation lives in ``core.channels``.

Hot-path layout (this refactor — protocol preserved bit-for-bit, see
``tests/test_golden_reports.py``):

- kernels are addressed by dense interned ids (``core.signatures``), so
  every per-kernel table is an integer-indexed array/dict instead of
  hashing a frozen dataclass per event;
- per-rank scalar state lives in ``core.pathset.EngineState`` NumPy
  struct-of-arrays, so the internal allreduce at collectives (max-path
  winner, clock sync, count adoption, vote) and ``report()`` are
  vectorized reductions over participant index arrays;
- ``predictable()`` verdicts are memoized inside ``KernelStats`` (n-keyed
  caches plus freq-monotonicity thresholds) and extrapolator predictions
  are memoized per sid between refits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .channels import ChannelRegistry
from .models import Extrapolator
from .pathset import ColdScalars, EngineState, WarmMirror
from .policies import Policy
from .signatures import Signature
from .stats import KernelStats

# Compiled warm-program opcodes — produced by the runtime's segment
# compiler (simmpi.runtime._build_warm), consumed by ``Critter.run_warm``.
# W_CHEAD / W_BHEAD are comp / comp-block entries that additionally head a
# fused per-rank segment (a maximal run of that rank's computation events
# between two of its skip-decision / communication boundaries); their
# member entries stay plain W_COMP / W_BLOCK and are consumed by a pending
# counter when the head batch-charges the whole segment.
W_COMP, W_BLOCK, W_CHEAD, W_BHEAD, W_COLL, W_P2P, W_IPOST, W_IMATCH = \
    range(8)


class IterationReport:
    """Everything the tuner wants to know about one configuration run."""

    __slots__ = ("predicted_time", "wall_time", "crit_comp", "crit_comm",
                 "measured_time", "max_measured_comp", "executed", "skipped",
                 "events")

    def __init__(self, predicted_time, wall_time, crit_comp, crit_comm,
                 measured_time, max_measured_comp, executed, skipped, events):
        self.predicted_time = predicted_time
        self.wall_time = wall_time
        self.crit_comp = crit_comp
        self.crit_comm = crit_comm
        self.measured_time = measured_time
        self.max_measured_comp = max_measured_comp
        self.executed = executed
        self.skipped = skipped
        self.events = events

    def __repr__(self):
        return (f"IterationReport(pred={self.predicted_time:.4g}s, "
                f"wall={self.wall_time:.4g}s, exec={self.executed}, "
                f"skip={self.skipped})")


class Critter:
    """Shared profiler state across tuning iterations.

    One instance per (policy, study); owns the struct-of-arrays per-rank
    Critter state, the channel registry (via the World), the eager global
    switch-off set, and the a-priori critical-path count snapshots.
    """

    def __init__(self, world, policy: Policy):
        self.world = world
        self.registry: ChannelRegistry = world.registry
        self.policy = policy
        self.state = EngineState(world.size)
        # eager propagation: signature ids switched off machine-wide, and
        # the globally-agreed statistics used to predict them
        self.global_off: set = set()
        self.global_stats: Dict[int, KernelStats] = {}
        # apriori: frozen critical-path execution counts from the offline
        # pass — a (ranks x sids) snapshot of the freq table
        self.apriori_counts: Optional[np.ndarray] = None
        # beyond-paper: per-op-family input-size extrapolation (§VIII);
        # fitted from the pooled kernel statistics at iteration start
        self.extrapolator: Optional[Extrapolator] = \
            Extrapolator(max_rel_err=policy.tolerance) \
            if policy.extrapolate else None
        self._extrap_cache: Dict[int, Optional[Tuple[float, float]]] = {}
        # runtime-facing mode flags (set per run by the tuner/runtime)
        self.force_execute = False
        self.update_stats = True
        # policy traits, resolved once (hot-path)
        self._tol = policy.tolerance
        self._ms = policy.min_samples
        self._vote_frac = policy.comm_vote_fraction
        self._eager = policy.name == "eager"
        self._once = policy.once_per_iteration
        self._propagates = policy.propagates_counts
        self._counts_local = policy.name in ("local", "online")
        self._apriori_mode = policy.name == "apriori"
        # live id -> Signature list (append-only, shared with the world's
        # interner — the runtime interns into the same table)
        self._sigs = world.interner.sigs
        # cross-study transfer: resolver Signature -> KernelStats-or-None
        # (repro.api.transfer); consumed lazily as signatures are interned
        self._prior_lookup = None
        self._prior_upto = 0
        # list-backed per-rank scalars, live only inside one forced run
        # (begin_cold .. finish_cold); see pathset.ColdScalars
        self._cs: Optional[ColdScalars] = None

    # ------------------------------------------------------------------ state

    def set_prior(self, lookup) -> None:
        """Install a transferred-statistics prior.  ``lookup(sig)`` returns
        an installable ``KernelStats`` (already discounted/remapped by the
        bank) or ``None``.  Seeding is lazy: signatures are interned by the
        runtime as programs first execute, so ``begin_iteration`` tops up
        the seed over any ids that appeared since — by the first selective
        trial (which follows a full reference execution) every kernel of
        the configuration carries its prior.  ``reset_models`` re-arms the
        seed, so studies that reset statistics between configurations warm
        every configuration, not just the first."""
        self._prior_lookup = lookup
        self._prior_upto = 0

    def _seed_prior(self) -> None:
        sigs = self._sigs
        lookup = self._prior_lookup
        S = self.state
        n_ranks = S.n_ranks
        eager = self._eager
        while self._prior_upto < len(sigs):
            sid = self._prior_upto
            self._prior_upto += 1
            st = lookup(sigs[sid])
            if st is None or st.n == 0:
                continue
            if sid >= S.cap:
                S.ensure(sid)
            for r in range(n_ranks):
                kb = S.kbar[r]
                if sid in kb:           # posterior beats prior: keep it
                    continue
                inst = kb[sid] = st.copy()
                S.mean_arr[r, sid] = inst.mean
                if eager:
                    self._note_stats(r, sid, inst)
            # an already-confident prior starts the kernel in the skip
            # regime.  For eager the bank stands in for a completed global
            # aggregation (its statistics came from a finished study), so
            # the kernel is switched off machine-wide outright; the
            # once-per-iteration policies keep their mandatory first
            # execution and skip every later occurrence from trial one.
            if eager and sid not in self.global_off \
                    and st.n >= self._ms \
                    and st.is_predictable(self._tol, 1, self._ms):
                self.global_off.add(sid)
                self.global_stats[sid] = st.copy()
                S.goff[sid] = True
                S.gmean[sid] = st.mean
                for r in range(n_ranks):
                    S.pred_live[r].discard(sid)

    def begin_iteration(self, *, force_execute=False, update_stats=True):
        self.state.reset_iteration()
        if self._prior_lookup is not None:
            self._seed_prior()
        self.force_execute = force_execute
        self.update_stats = update_stats
        if self.extrapolator is not None:
            pooled = self.pooled_kbar()
            # family models PERSIST across configurations (unlike the
            # per-signature statistics, which the paper's protocol resets):
            # a model fitted on one configuration's kernel sizes predicts
            # another configuration's different sizes — the cross-config
            # generalization per-signature modeling cannot provide
            if pooled:
                self.extrapolator.refit(pooled)
            self._extrap_cache.clear()

    def pooled_kbar(self) -> Dict[Signature, KernelStats]:
        """First-seen-per-rank pooling of the kernel statistics (used by the
        extrapolator refit and the beyond-paper benchmarks)."""
        sigs = self._sigs
        pooled: Dict[Signature, KernelStats] = {}
        for d in self.state.kbar:
            for sid, stats in d.items():
                sig = sigs[sid]
                if sig not in pooled:
                    pooled[sig] = stats
        return pooled

    def snapshot_apriori_counts(self):
        """Freeze the current per-rank critical-path counts (after a full
        offline pass) for immediate use by the 'apriori' policy."""
        self.apriori_counts = self.state.freq.copy()
        self.state.skip_ok.fill(False)

    def reset_models(self):
        """Paper §VI.A: reset kernel statistics between configurations
        (SLATE/CANDMC studies); eager persists models across configs."""
        self.state.reset_models()
        self.global_off = set()
        self.global_stats = {}
        self.apriori_counts = None
        self._prior_upto = 0       # re-arm transferred priors (set_prior)

    # -------------------------------------------------------------- decisions

    def _freq(self, rank: int, sid: int) -> int:
        """The execution count used to shrink the CI (policy-dependent)."""
        if self._counts_local:
            # local / online: current sub-critical-path running count
            f = int(self.state.freq[rank, sid])
            return f if f > 1 else 1
        if self._apriori_mode and self.apriori_counts is not None:
            ap = self.apriori_counts
            f = int(ap[rank, sid]) if sid < ap.shape[1] else 0
            return f if f > 1 else 1
        # conditional / eager: no execution-count usage
        return 1

    def _extrapolatable(self, sid: int) -> bool:
        """Beyond-paper: a kernel NEVER executed may be skipped when its
        family model's validation error meets the tolerance (§VIII)."""
        if self.extrapolator is None:
            return False
        pred = self._extrap_predict(sid)
        return pred is not None and pred[1] <= self._tol

    def _extrap_predict(self, sid: int):
        """Memoized extrapolator prediction (valid between refits)."""
        cache = self._extrap_cache
        if sid in cache:
            return cache[sid]
        pred = self.extrapolator.predict(self._sigs[sid])
        cache[sid] = pred
        return pred

    def predictable(self, rank: int, sid: int) -> bool:
        if self.state.skip_ok[rank, sid]:
            return True      # memoized skip verdict implies predictability
        if sid in self.global_off:
            return True
        stats = self.state.kbar[rank].get(sid)
        if stats is None or stats.n < self._ms:
            return self._extrapolatable(sid)
        return stats.is_predictable(self._tol, self._freq(rank, sid),
                                    self._ms)

    def _skip_verdict(self, rank: int, sid: int) -> bool:
        """The rank-local execute vote, memoized: True means SKIP.

        A skip verdict is cached in ``skip_ok`` only when it holds at
        critical-path count 1 (``is_predictable(tol, 1, ms)``), which makes
        the cache immune to count adoption — the relative CI only shrinks
        as freq grows — so a cached cell stays valid until the (rank, sid)
        statistics change (cleared at every real execution and at eager
        aggregation installs) or the iteration ends.
        """
        S = self.state
        if S.skip_ok[rank, sid]:
            return True
        if self._once and not S.iter_exec[rank, sid]:
            # beyond-paper: never-executed kernels with a validated family
            # model may be skipped outright (§VIII extrapolation)
            if not (self._never_ran(rank, sid)
                    and self._extrapolatable(sid)):
                return False
        if not self.predictable(rank, sid):
            return False
        stats = S.kbar[rank].get(sid)
        if stats is not None and stats.n > 0 \
                and stats.is_predictable(self._tol, 1, self._ms):
            S.skip_ok[rank, sid] = True
        return True

    def _predicted_mean(self, rank: int, sid: int) -> float:
        g = self.global_stats.get(sid)
        if g is not None:
            return g.mean
        m = self.state.mean_arr[rank, sid]
        if m == m:                       # not NaN: stats present with n > 0
            return float(m)
        if self.extrapolator is not None:
            pred = self._extrap_predict(sid)
            if pred is not None:
                return pred[0]
        return 0.0

    def _never_ran(self, rank: int, sid: int) -> bool:
        stats = self.state.kbar[rank].get(sid)
        return stats is None or stats.n == 0

    def _note_stats(self, rank: int, sid: int, stats: KernelStats) -> None:
        """Eager-only: keep ``pred_live[rank]`` in sync after a statistics
        write.  Membership mirrors the aggregate_statistics candidate
        precondition — predictable at critical-path count 1 — and is NOT
        monotone (new samples can widen the CI), so the verdict is
        recomputed at every write; ``is_predictable`` memoizes on (n, tol)
        so this is one cached check per write."""
        if stats.n >= self._ms and stats.is_predictable(self._tol, 1,
                                                        self._ms):
            if sid not in self.global_off:
                self.state.pred_live[rank].add(sid)
        else:
            self.state.pred_live[rank].discard(sid)

    def _should_execute_local(self, rank: int, sid: int) -> bool:
        if self.force_execute:
            return True
        if sid in self.global_off:
            return False
        if self._eager:
            # eager skips only once the kernel is switched off machine-wide
            # (predictable on some rank AND propagated globally)
            return True
        return not self._skip_verdict(rank, sid)

    # ----------------------------------------------------------- comp kernels

    def on_comp(self, rank: int, sid: int, sampler) -> float:
        """BLAS/LAPACK interception.  Computation kernel execution decisions
        are made independently per processor (default policy, §III.B).
        Returns the wall-clock time the rank spends (0 when skipped)."""
        S = self.state
        if sid >= S.cap:
            S.ensure(sid)
        # fused fast path: memoized skip verdict (or eager global switch-off)
        if not self.force_execute:
            if self._eager:
                skip = S.goff[sid]
                t = S.gmean[sid] if skip else 0.0
            else:
                skip = S.skip_ok[rank, sid]
                t = S.mean_arr[rank, sid] if skip else 0.0
            if skip:
                S.skipped[rank] += 1
                S.path_exec[rank] += t
                S.path_comp[rank] += t
                S.path_kernels[rank] += 1
                S.freq[rank, sid] += 1
                S.seen[rank, sid] = True
                return 0.0
        if self._should_execute_local(rank, sid):
            t = sampler(self._sigs[sid])
            if self.update_stats:
                stats = S.stats(rank, sid)
                stats.update(t)
                S.mean_arr[rank, sid] = stats.mean
                if self._eager:
                    self._note_stats(rank, sid, stats)
            S.iter_exec[rank, sid] = True
            S.clock[rank] += t
            S.measured_time[rank] += t
            S.measured_comp[rank] += t
            S.executed[rank] += 1
            wall = t
        else:
            t = self._predicted_mean(rank, sid)
            S.skipped[rank] += 1
            wall = 0.0
        S.path_exec[rank] += t
        S.path_comp[rank] += t
        S.path_kernels[rank] += 1
        S.freq[rank, sid] += 1
        S.seen[rank, sid] = True
        return wall

    def on_comp_block(self, rank: int, block, sampler) -> float:
        """A run of consecutive computation kernels of one rank (produced by
        the runtime's trace compiler).  When every kernel in the run has a
        memoized skip verdict — the steady state after warmup — the whole
        run is charged in one vectorized step; otherwise it falls back to
        per-kernel ``on_comp`` (identical decisions, identical RNG use).

        The predicted times are accumulated sequentially in the same order
        as individual events, so path metrics stay bit-identical."""
        S = self.state
        if block.max_sid >= S.cap:
            S.ensure(block.max_sid)
        sids_np = block.sids_np
        if not self.force_execute:
            if self._eager:
                ok = S.goff[sids_np]
                means = S.gmean[sids_np] if ok.all() else None
            else:
                ok = S.skip_ok[rank, sids_np]
                means = S.mean_arr[rank, sids_np] if ok.all() else None
            if means is not None:
                pe = float(S.path_exec[rank])
                pc = float(S.path_comp[rank])
                for t in means.tolist():
                    pe += t
                    pc += t
                S.path_exec[rank] = pe
                S.path_comp[rank] = pc
                S.path_kernels[rank] += block.n
                S.skipped[rank] += block.n
                S.freq[rank, block.uniq] += block.counts
                S.seen[rank, block.uniq] = True
                return 0.0
        wall = 0.0
        on_comp = self.on_comp
        for sid in block.sids:
            wall += on_comp(rank, sid, sampler)
        return wall

    # -- batched cold (forced) fast path --------------------------------------
    #
    # The ``*_cold`` interceptions are force-execute specializations used by
    # the runtime's cold interpreter: the sample is drawn up front (the
    # recording/reference run samples every kernel, so draws hoist and
    # vectorize), the execute vote is constant-True, and three per-event
    # writes are elided because nothing can observe them during a forced
    # run:
    #
    # - ``skip_ok`` is all-False after ``reset_iteration`` and nothing sets
    #   it under force (the vote paths that memoize verdicts are skipped),
    #   so writing False is a no-op;
    # - ``iter_exec`` is only read by the selective vote paths (never under
    #   force) and reset at the next ``begin_iteration``; the interpreter
    #   sets the run's statically-known (rank, sid) execution set in one
    #   vectorized pass at the end (``finish_cold``);
    # - ``mean_arr`` is only read by skip-prediction paths (never under
    #   force); ``finish_cold`` mirrors the final K-bar means once per
    #   touched (rank, sid) instead of once per event.  Eager aggregation
    #   at collectives maintains its own mean_arr writes as usual.
    #
    # ``pred_live`` (eager) IS maintained per statistics write — collective
    # aggregation reads it mid-run.
    # Per-rank scalar timers (clock, path profile, measured accumulators,
    # counters) live in list-backed mirrors for the duration of the forced
    # run (``begin_cold`` .. ``finish_cold``; see ``pathset.ColdScalars``):
    # the p2p-heavy interception hot path touches several of them per event
    # for two ranks, and Python-list access is several times cheaper than
    # NumPy scalar indexing while performing the identical IEEE arithmetic.
    # Everything else — Welford statistics, freq (read mid-run by Isend
    # snapshots), seen (read by count adoption) — follows the exact
    # operation order of the scalar methods, so reports, state, and RNG
    # streams stay bit-identical (tests/test_cold_path.py).

    def begin_cold(self) -> ColdScalars:
        """Enter list-backed scalar mode for one forced run (the cold
        interpreter calls this right after growing column capacity)."""
        self._cs = cs = ColdScalars(self.state)
        return cs

    def on_comp_cold(self, rank: int, sid: int, t: float) -> float:
        """Force-execute charging of one computation kernel with a
        precomputed sample (mirrors the execute branch of ``on_comp``; the
        caller has grown column capacity over every sid of the program)."""
        S = self.state
        cs = self._cs
        if self.update_stats:
            stats = S.stats(rank, sid)
            stats.update(t)
            if self._eager:
                self._note_stats(rank, sid, stats)
        cs.clock[rank] += t
        cs.measured_time[rank] += t
        cs.measured_comp[rank] += t
        cs.executed[rank] += 1
        cs.path_exec[rank] += t
        cs.path_comp[rank] += t
        cs.path_kernels[rank] += 1
        S.freq[rank, sid] += 1
        S.seen[rank, sid] = True
        return t

    def on_comp_block_cold(self, rank: int, block, ts) -> float:
        """Force-execute charging of a fused run of computation kernels
        with precomputed samples ``ts`` (Python floats, block order).

        Scalar accumulators (clock, measured, path) are accumulated
        sequentially over Python floats — the same additions in the same
        order as per-event ``on_comp`` — and the Welford statistics of
        each distinct kernel see their samples in block order
        (``KernelStats.update_many``), so every derived quantity is
        bit-identical to the scalar path."""
        S = self.state
        cs = self._cs
        if self.update_stats:
            eager = self._eager
            uniq = block.uniq.tolist()
            groups = block.group_indices()
            for sid, idx in zip(uniq, groups):
                stats = S.stats(rank, sid)
                if len(idx) == block.n:
                    stats.update_many(ts)
                else:
                    stats.update_many([ts[i] for i in idx])
                if eager:
                    self._note_stats(rank, sid, stats)
        c = cs.clock[rank]
        mt = cs.measured_time[rank]
        mc = cs.measured_comp[rank]
        pe = cs.path_exec[rank]
        pc = cs.path_comp[rank]
        total = 0.0
        for t in ts:
            c += t
            mt += t
            mc += t
            pe += t
            pc += t
            total += t
        cs.clock[rank] = c
        cs.measured_time[rank] = mt
        cs.measured_comp[rank] = mc
        cs.path_exec[rank] = pe
        cs.path_comp[rank] = pc
        cs.executed[rank] += block.n
        cs.path_kernels[rank] += block.n
        S.freq[rank, block.uniq] += block.counts
        S.seen[rank, block.uniq] = True
        return total

    def on_coll_cold(self, sid: int, comm, t: float,
                     overhead: float = 0.0) -> float:
        """Force-execute completion of a blocking collective with a
        precomputed sample (mirrors the force branch of ``on_coll``:
        winner adoption, clock sync, per-participant statistics update,
        eager aggregation — with the per-rank scalars on the list mirrors
        and the ``iter_exec``/``mean_arr`` writes deferred to
        ``finish_cold`` like every other cold interception)."""
        S = self.state
        cs = self._cs
        ranks = comm.ranks
        ridx = comm.ranks_np
        pe = cs.path_exec
        clock = cs.clock
        # first-max winner / clock max, matching take().argmax()/max()
        winner = ranks[0]
        best = pe[winner]
        max_clock = clock[winner]
        for r in ranks[1:]:
            v = pe[r]
            if v > best:
                best = v
                winner = r
            c = clock[r]
            if c > max_clock:
                max_clock = c
        if self._propagates:
            wseen = S.seen[winner]
            S.freq[ridx] = np.where(wseen, S.freq[winner], S.freq[ridx])
            S.seen[ridx] |= wseen
        pc = cs.path_comp
        pm = cs.path_comm
        pk = cs.path_kernels
        pew = pe[winner]
        pcw = pc[winner]
        pmw = pm[winner]
        pkw = pk[winner]

        max_clock += overhead  # internal-allreduce profiling cost
        new_clock = max_clock + t
        update = self.update_stats
        eager = self._eager
        mt = cs.measured_time
        ex = cs.executed
        for r in ranks:
            if update:
                stats = S.stats(r, sid)
                stats.update(t)
                if eager:
                    self._note_stats(r, sid, stats)
            clock[r] = new_clock
            mt[r] += t
            ex[r] += 1
            pe[r] = pew + t
            pc[r] = pcw
            pm[r] = pmw + t
            pk[r] = pkw + 1
        S.freq[ridx, sid] += 1
        S.seen[ridx, sid] = True
        if eager and comm.channel is not None:
            self._aggregate_statistics(comm)
        return new_clock

    def on_p2p_cold(self, src: int, dst: int, sid: int, t: float,
                    overhead: float = 0.0) -> float:
        """Force-execute completion of a blocking Send/Recv pair with a
        precomputed sample (mirrors the execute branch of ``on_p2p``)."""
        S = self.state
        cs = self._cs
        pe = cs.path_exec
        winner, loser = (src, dst) if pe[src] > pe[dst] else (dst, src)
        if self._propagates:
            wseen = S.seen[winner]
            np.copyto(S.freq[loser], S.freq[winner], where=wseen)
            S.seen[loser] |= wseen
        pe[loser] = pe[winner]
        pc = cs.path_comp
        pm = cs.path_comm
        pk = cs.path_kernels
        pc[loser] = pc[winner]
        pm[loser] = pm[winner]
        pk[loser] = pk[winner]

        clock = cs.clock
        a = clock[src]
        b = clock[dst]
        done = (a if a > b else b) + overhead + t
        update = self.update_stats
        eager = self._eager
        mt = cs.measured_time
        ex = cs.executed
        for r in (src, dst):
            if update:
                stats = S.stats(r, sid)
                stats.update(t)
                if eager:
                    self._note_stats(r, sid, stats)
            mt[r] += t
            ex[r] += 1
            pe[r] += t
            pm[r] += t
            pk[r] += 1
            S.freq[r, sid] += 1
            S.seen[r, sid] = True
        clock[src] = done
        clock[dst] = done
        return done

    def on_isend_match_cold(self, src: int, dst: int, sid: int, t: float,
                            snapshot, overhead: float = 0.0):
        """Force-execute completion of a buffered Isend matched by a Recv
        with a precomputed sample (mirrors the execute branch of
        ``on_isend_match``; the sender-local vote is constant-True under
        force, so the interpreter's post slots carry only the snapshot)."""
        S = self.state
        cs = self._cs
        (p_exec, p_comp, p_comm, p_kc), post_freqs, post_clock = snapshot

        if p_exec > cs.path_exec[dst]:
            if self._propagates and post_freqs is not None:
                m = post_freqs.shape[0]
                mask = post_freqs > 0
                np.copyto(S.freq[dst, :m], post_freqs, where=mask)
                S.seen[dst, :m] |= mask
            cs.path_exec[dst] = p_exec
            cs.path_comp[dst] = p_comp
            cs.path_comm[dst] = p_comm
            cs.path_kernels[dst] = p_kc

        cd = cs.clock[dst]
        done = (post_clock if post_clock > cd else cd) + overhead + t
        if self.update_stats:
            eager = self._eager
            for r in (src, dst):
                stats = S.stats(r, sid)
                stats.update(t)
                if eager:
                    self._note_stats(r, sid, stats)
        cs.executed[src] += 1
        cs.executed[dst] += 1
        cs.measured_time[dst] += t
        cs.path_exec[dst] += t
        cs.path_comm[dst] += t
        cs.path_kernels[dst] += 1
        S.freq[dst, sid] += 1
        S.seen[dst, sid] = True
        cs.clock[dst] = done
        return done

    def isend_snapshot_cold(self, rank: int):
        """``isend_snapshot`` against the list mirrors (the values are
        already Python scalars)."""
        S = self.state
        cs = self._cs
        freqs = S.freq[rank].copy() if self._propagates else None
        path = (cs.path_exec[rank], cs.path_comp[rank],
                cs.path_comm[rank], cs.path_kernels[rank])
        return (path, freqs, cs.clock[rank])

    def finish_cold(self, rows, cols) -> None:
        """End-of-forced-run bulk pass: write the list-backed per-rank
        scalars back to the arrays, set ``iter_exec`` over the run's
        statically-known (rank, sid) execution pairs and mirror the final
        K-bar means into ``mean_arr`` (both deferred from the per-event
        cold interceptions above)."""
        S = self.state
        cs = self._cs
        if cs is not None:
            cs.writeback(S)
            self._cs = None
        S.iter_exec[rows, cols] = True
        if self.update_stats:
            kbar = S.kbar
            mean_arr = S.mean_arr
            for r, s in zip(rows.tolist(), cols.tolist()):
                mean_arr[r, s] = kbar[r][s].mean

    # -- compiled warm (selective) fast path ----------------------------------
    #
    # ``run_warm`` replays a compiled warm program (simmpi.runtime builds it
    # from the recorded event stream) through list-backed mirrors of the
    # full engine state (pathset.WarmMirror): the selective hot path is
    # dominated by scalar skip-table reads and per-rank accumulator
    # read-modify-writes, which Python lists serve several times cheaper
    # than NumPy scalar indexing at identical IEEE arithmetic.  Fused
    # per-rank comp segments batch-charge their predicted means in event
    # order when every kernel in the segment holds a memoized skip verdict
    # (the steady state); any guard miss falls back to per-event decisions
    # at the original program positions, so decisions, statistics updates
    # and RNG consumption are bit-identical to the scalar interpreter
    # (tests/test_compiled_path.py, tests/test_cold_path.py).

    def warm_eligible(self) -> bool:
        """True when ``run_warm`` reproduces the scalar engine exactly.

        The compiled interpreter specializes away the extrapolation
        branches (every shipped policy has ``extrapolate=False``) and
        assumes ``global_off`` is populated only under eager propagation —
        an invariant of the protocol (only ``_aggregate_statistics`` and
        the eager prior seed add to it) asserted here for safety."""
        return self.extrapolator is None \
            and (self._eager or not self.global_off)

    def run_warm(self, warm, sampler, overhead: float = 0.0) -> None:
        """Replay one compiled warm program (selective, non-forced run)."""
        S = self.state
        nlive = len(self._sigs)
        need = warm.max_sid if warm.max_sid >= nlive else nlive - 1
        if need >= S.cap:
            S.ensure(need)
        wm = WarmMirror(S, nlive)

        # mirror views / resolved traits (locals: closure-cell reads only)
        clock = wm.clock
        pe = wm.path_exec
        pc = wm.path_comp
        pm = wm.path_comm
        pk = wm.path_kernels
        mt = wm.measured_time
        mcmp = wm.measured_comp
        ex = wm.executed
        sk = wm.skipped
        freq_rows = wm.freq
        seen_rows = wm.seen
        iter_rows = wm.iter_exec
        mean_rows = wm.mean
        sko_rows = wm.skip_ok
        goff = wm.goff
        gmean = wm.gmean
        sigs = self._sigs
        kbar = S.kbar
        update = self.update_stats
        eager = self._eager
        once = self._once
        propagates = self._propagates
        counts_local = self._counts_local
        tol = self._tol
        ms = self._ms
        vote_frac = self._vote_frac
        global_off = self.global_off
        global_stats = self.global_stats
        note = self._note_stats
        ap = self.apriori_counts if self._apriori_mode else None
        apw = ap.shape[1] if ap is not None else 0

        slots = [None] * warm.n_slots
        pend = [0] * S.n_ranks      # member entries of a batch-charged run

        # -- decision helpers (exact mirrors of the scalar methods) ----------

        def predictable(r, sid):
            if sko_rows[r][sid]:
                return True
            if sid in global_off:
                return True
            stats = kbar[r].get(sid)
            if stats is None or stats.n < ms:
                return False
            if counts_local:
                f = freq_rows[r][sid]
                if f < 1:
                    f = 1
            elif ap is not None:
                f = int(ap[r, sid]) if sid < apw else 0
                if f < 1:
                    f = 1
            else:
                f = 1
            return stats.is_predictable(tol, f, ms)

        def skip_verdict(r, sid):
            # True means SKIP; memoizes count-1 verdicts into the mirror
            if sko_rows[r][sid]:
                return True
            if once and not iter_rows[r][sid]:
                return False
            if not predictable(r, sid):
                return False
            stats = kbar[r].get(sid)
            if stats is not None and stats.n > 0 \
                    and stats.is_predictable(tol, 1, ms):
                sko_rows[r][sid] = True
            return True

        def p2p_vote(r, sid):
            # callers have already checked sko_rows[r][sid] is False
            if sid in global_off:
                return False
            return not skip_verdict(r, sid)

        if eager:
            def pmean(r, sid):
                g = global_stats.get(sid)
                if g is not None:
                    return g.mean
                m = mean_rows[r][sid]
                return m if m == m else 0.0
        else:
            # non-eager protocols never populate global_stats
            def pmean(r, sid):
                m = mean_rows[r][sid]
                return m if m == m else 0.0

        def comp_slow(r, sid):
            # the memoized fast skip check already failed
            if eager:
                execute = True      # goff is False here, never switched off
            else:
                execute = not skip_verdict(r, sid)
            if execute:
                t = sampler(sigs[sid])
                if update:
                    d = kbar[r]
                    stats = d.get(sid)
                    if stats is None:
                        stats = d[sid] = KernelStats()
                    stats.update(t)
                    mean_rows[r][sid] = stats.mean
                    if eager:
                        note(r, sid, stats)
                iter_rows[r][sid] = True
                clock[r] += t
                mt[r] += t
                mcmp[r] += t
                ex[r] += 1
            else:
                t = pmean(r, sid)
                sk[r] += 1
            pe[r] += t
            pc[r] += t
            pk[r] += 1
            freq_rows[r][sid] += 1
            seen_rows[r][sid] = True

        def comp_one(r, sid):
            if eager:
                if goff[sid]:
                    t = gmean[sid]
                else:
                    comp_slow(r, sid)
                    return
            elif sko_rows[r][sid]:
                t = mean_rows[r][sid]
            else:
                comp_slow(r, sid)
                return
            sk[r] += 1
            pe[r] += t
            pc[r] += t
            pk[r] += 1
            freq_rows[r][sid] += 1
            seen_rows[r][sid] = True

        def block_entry(r, bsids, buniq, bcounts, bn):
            if eager:
                ok = True
                for s in buniq:
                    if not goff[s]:
                        ok = False
                        break
                mr = gmean
            else:
                skr = sko_rows[r]
                ok = True
                for s in buniq:
                    if not skr[s]:
                        ok = False
                        break
                mr = mean_rows[r]
            if ok:
                a = pe[r]
                b = pc[r]
                for s in bsids:
                    t = mr[s]
                    a += t
                    b += t
                pe[r] = a
                pc[r] = b
                pk[r] += bn
                sk[r] += bn
                fr = freq_rows[r]
                sr = seen_rows[r]
                for s, c in zip(buniq, bcounts):
                    fr[s] += c
                    sr[s] = True
                return True
            for s in bsids:
                comp_one(r, s)
            return False

        def coll_vote(ranks, sid):
            all_ok = True
            for r in ranks:
                if not sko_rows[r][sid]:
                    all_ok = False
                    break
            if all_ok:
                return False
            if once:
                for r in ranks:
                    if not iter_rows[r][sid]:
                        return True
            thr = vote_frac * len(ranks)
            n_pred = 0
            left = len(ranks)
            for r in ranks:
                left -= 1
                if predictable(r, sid):
                    n_pred += 1
                    if n_pred >= thr:
                        break
                elif n_pred + left < thr:
                    return True
            if n_pred < thr:
                return True
            if vote_frac >= 1.0:
                for r in ranks:
                    stats = kbar[r].get(sid)
                    if stats is not None and stats.n > 0 \
                            and stats.is_predictable(tol, 1, ms):
                        sko_rows[r][sid] = True
            return False

        # -- interpreter loop -------------------------------------------------

        for e in warm.entries:
            k = e[0]
            if k == W_COMP:
                r = e[1]
                if pend[r]:
                    pend[r] -= 1
                    continue
                sid = e[2]
                if eager:
                    if not goff[sid]:
                        comp_slow(r, sid)
                        continue
                    t = gmean[sid]
                elif sko_rows[r][sid]:
                    t = mean_rows[r][sid]
                else:
                    comp_slow(r, sid)
                    continue
                sk[r] += 1
                pe[r] += t
                pc[r] += t
                pk[r] += 1
                freq_rows[r][sid] += 1
                seen_rows[r][sid] = True
            elif k == W_IMATCH:
                _, src, dst, sid, slot, sig = e
                vote, p_exec, p_comp, p_comm, p_kc, post_freqs, post_clock \
                    = slots[slot]
                if vote:
                    execute = True
                elif sko_rows[dst][sid]:
                    execute = False
                else:
                    execute = p2p_vote(dst, sid)
                if p_exec > pe[dst]:
                    if post_freqs is not None:
                        fd = freq_rows[dst]
                        sd = seen_rows[dst]
                        i = 0
                        for v in post_freqs:
                            if v > 0:
                                fd[i] = v
                                sd[i] = True
                            i += 1
                    pe[dst] = p_exec
                    pc[dst] = p_comp
                    pm[dst] = p_comm
                    pk[dst] = p_kc
                cd = clock[dst]
                base = (post_clock if post_clock > cd else cd) + overhead
                if execute:
                    t = sampler(sig)
                    for r in (src, dst):
                        if update:
                            d = kbar[r]
                            stats = d.get(sid)
                            if stats is None:
                                stats = d[sid] = KernelStats()
                            stats.update(t)
                            mean_rows[r][sid] = stats.mean
                            sko_rows[r][sid] = False
                            if eager:
                                note(r, sid, stats)
                        iter_rows[r][sid] = True
                        ex[r] += 1
                    mt[dst] += t
                    clock[dst] = base + t
                else:
                    sk[src] += 1
                    sk[dst] += 1
                    if eager:
                        t = pmean(dst, sid)
                    else:
                        t = mean_rows[dst][sid]
                        if t != t:               # NaN: no statistics yet
                            t = 0.0
                    clock[dst] = base
                pe[dst] += t
                pm[dst] += t
                pk[dst] += 1
                freq_rows[dst][sid] += 1
                seen_rows[dst][sid] = True
            elif k == W_IPOST:
                _, r, sid, slot = e
                if sko_rows[r][sid]:
                    vote = False
                else:
                    vote = p2p_vote(r, sid)
                slots[slot] = (vote, pe[r], pc[r], pm[r], pk[r],
                               freq_rows[r][:] if propagates else None,
                               clock[r])
            elif k == W_CHEAD:
                r = e[1]
                run = e[3]
                rsids, runiq, rcounts, rn, extra = run
                if eager:
                    ok = True
                    for s in runiq:
                        if not goff[s]:
                            ok = False
                            break
                    mr = gmean
                else:
                    skr = sko_rows[r]
                    ok = True
                    for s in runiq:
                        if not skr[s]:
                            ok = False
                            break
                    mr = mean_rows[r]
                if ok:
                    a = pe[r]
                    b = pc[r]
                    for s in rsids:
                        t = mr[s]
                        a += t
                        b += t
                    pe[r] = a
                    pc[r] = b
                    pk[r] += rn
                    sk[r] += rn
                    fr = freq_rows[r]
                    sr = seen_rows[r]
                    for s, c in zip(runiq, rcounts):
                        fr[s] += c
                        sr[s] = True
                    pend[r] = extra
                else:
                    comp_one(r, e[2])
            elif k == W_BLOCK:
                r = e[1]
                if pend[r]:
                    pend[r] -= 1
                    continue
                block_entry(r, e[2], e[3], e[4], e[5])
            elif k == W_BHEAD:
                r = e[1]
                rsids, runiq, rcounts, rn, extra = e[6]
                if eager:
                    ok = True
                    for s in runiq:
                        if not goff[s]:
                            ok = False
                            break
                    mr = gmean
                else:
                    skr = sko_rows[r]
                    ok = True
                    for s in runiq:
                        if not skr[s]:
                            ok = False
                            break
                    mr = mean_rows[r]
                if ok:
                    a = pe[r]
                    b = pc[r]
                    for s in rsids:
                        t = mr[s]
                        a += t
                        b += t
                    pe[r] = a
                    pc[r] = b
                    pk[r] += rn
                    sk[r] += rn
                    fr = freq_rows[r]
                    sr = seen_rows[r]
                    for s, c in zip(runiq, rcounts):
                        fr[s] += c
                        sr[s] = True
                    pend[r] = extra
                else:
                    block_entry(r, e[2], e[3], e[4], e[5])
            elif k == W_P2P:
                src = e[1]
                dst = e[2]
                sid = e[3]
                if sko_rows[src][sid]:
                    vote = False
                else:
                    vote = p2p_vote(src, sid)
                if vote:
                    execute = True
                elif sko_rows[dst][sid]:
                    execute = False
                else:
                    execute = p2p_vote(dst, sid)
                if pe[src] > pe[dst]:
                    w = src
                    l = dst
                else:
                    w = dst
                    l = src
                if propagates:
                    ws = seen_rows[w]
                    fw = freq_rows[w]
                    fl = freq_rows[l]
                    sl = seen_rows[l]
                    i = 0
                    for flag in ws:
                        if flag:
                            fl[i] = fw[i]
                            sl[i] = True
                        i += 1
                pe[l] = pe[w]
                pc[l] = pc[w]
                pm[l] = pm[w]
                pk[l] = pk[w]
                a = clock[src]
                b = clock[dst]
                base = (a if a > b else b) + overhead
                if execute:
                    t = sampler(e[4])
                    done = base + t
                    for r in (src, dst):
                        if update:
                            d = kbar[r]
                            stats = d.get(sid)
                            if stats is None:
                                stats = d[sid] = KernelStats()
                            stats.update(t)
                            mean_rows[r][sid] = stats.mean
                            sko_rows[r][sid] = False
                            if eager:
                                note(r, sid, stats)
                        iter_rows[r][sid] = True
                        mt[r] += t
                        ex[r] += 1
                        pe[r] += t
                        pm[r] += t
                        pk[r] += 1
                        freq_rows[r][sid] += 1
                        seen_rows[r][sid] = True
                else:
                    done = base
                    for r in (src, dst):
                        sk[r] += 1
                        t = pmean(r, sid)
                        pe[r] += t
                        pm[r] += t
                        pk[r] += 1
                        freq_rows[r][sid] += 1
                        seen_rows[r][sid] = True
                clock[src] = done
                clock[dst] = done
            else:                           # W_COLL
                sid = e[1]
                comm = e[2]
                ranks = e[3]
                # longest path wins (first max, matching argmax)
                w = ranks[0]
                best = pe[w]
                max_clock = clock[w]
                for r in ranks:
                    v = pe[r]
                    if v > best:
                        best = v
                        w = r
                    c = clock[r]
                    if c > max_clock:
                        max_clock = c
                if propagates:
                    ws = seen_rows[w]
                    fw = freq_rows[w]
                    for r in ranks:
                        if r == w:
                            continue
                        fr = freq_rows[r]
                        sr = seen_rows[r]
                        i = 0
                        for flag in ws:
                            if flag:
                                fr[i] = fw[i]
                                sr[i] = True
                            i += 1
                wpe = pe[w]
                wpc = pc[w]
                wpm = pm[w]
                wpk = pk[w]
                for r in ranks:
                    pe[r] = wpe
                    pc[r] = wpc
                    pm[r] = wpm
                    pk[r] = wpk
                if eager:
                    execute = not goff[sid]
                else:
                    execute = coll_vote(ranks, sid)
                max_clock += overhead
                if execute:
                    t = sampler(e[4])
                    new_clock = max_clock + t
                    for r in ranks:
                        if update:
                            d = kbar[r]
                            stats = d.get(sid)
                            if stats is None:
                                stats = d[sid] = KernelStats()
                            stats.update(t)
                            mean_rows[r][sid] = stats.mean
                            if eager:
                                note(r, sid, stats)
                            sko_rows[r][sid] = False
                        iter_rows[r][sid] = True
                        clock[r] = new_clock
                        mt[r] += t
                        ex[r] += 1
                        pe[r] += t
                        pm[r] += t
                        pk[r] += 1
                        freq_rows[r][sid] += 1
                        seen_rows[r][sid] = True
                else:
                    for r in ranks:
                        t = pmean(r, sid)
                        clock[r] = max_clock
                        sk[r] += 1
                        pe[r] += t
                        pm[r] += t
                        pk[r] += 1
                        freq_rows[r][sid] += 1
                        seen_rows[r][sid] = True
                if eager and comm.channel is not None:
                    # aggregation reads K-bar/pred_live (live objects) and
                    # writes the prediction ARRAYS; sync the participants'
                    # mirror rows around it and re-pull the global tables
                    for r in ranks:
                        wm.push_rank(S, r)
                    self._aggregate_statistics(comm)
                    for r in ranks:
                        wm.pull_rank(S, r)
                    wm.pull_global(S)
                    goff = wm.goff
                    gmean = wm.gmean

        wm.writeback(S)

    def on_coll(self, sid: int, comm, sampler, overhead: float = 0.0) -> float:
        """Blocking-collective interception (Figure 2, MPI_Bcast et al.).

        1. internal PMPI_Allreduce over the channel: max path time wins, the
           winner's K-tilde keys/freqs are adopted by dominated ranks
           ('online' policy), execute votes are OR-reduced;
        2. clocks synchronize (the internal allreduce is itself a barrier);
        3. the user collective is selectively executed; every participant
           invokes update_statistics on a real execution;
        4. eager propagation invokes aggregate_statistics across the channel
           and may switch the kernel off globally once the aggregate-channel
           closure covers the world communicator.

        Returns the post-completion clock shared by all participants.
        """
        S = self.state
        if sid >= S.cap:
            S.ensure(sid)
        ranks = comm.ranks
        ridx = comm.ranks_np

        # -- internal allreduce: longest path wins (vectorized) --------------
        winner = ranks[int(S.path_exec.take(ridx).argmax())]
        max_clock = float(S.clock.take(ridx).max())
        if self._propagates:
            # dominated ranks adopt the winner's critical-path counts for
            # every kernel the winner has seen, keeping their own otherwise
            wseen = S.seen[winner]
            S.freq[ridx] = np.where(wseen, S.freq[winner], S.freq[ridx])
            S.seen[ridx] |= wseen
        S.path_exec[ridx] = S.path_exec[winner]
        S.path_comp[ridx] = S.path_comp[winner]
        S.path_comm[ridx] = S.path_comm[winner]
        S.path_kernels[ridx] = S.path_kernels[winner]

        # -- execute vote (OR-reduced across the channel) --------------------
        if self.force_execute:
            execute = True
        elif sid in self.global_off:
            execute = False
        elif self._eager:
            execute = True   # until switched off by global propagation
        else:
            execute = self._coll_vote(ranks, ridx, sid)

        # -- selective execution + statistics update -------------------------
        max_clock += overhead  # internal-allreduce profiling cost
        if execute:
            t = sampler(self._sigs[sid])
            new_clock = max_clock + t
            if self.update_stats:
                mean_col = S.mean_arr
                eager = self._eager
                for r in ranks:
                    stats = S.stats(r, sid)
                    stats.update(t)
                    mean_col[r, sid] = stats.mean
                    if eager:
                        self._note_stats(r, sid, stats)
                S.skip_ok[ridx, sid] = False    # statistics changed
            S.iter_exec[ridx, sid] = True
            S.clock[ridx] = new_clock
            S.measured_time[ridx] += t
            S.executed[ridx] += 1
            S.path_exec[ridx] += t
            S.path_comm[ridx] += t
        else:
            new_clock = max_clock
            tvec = self._predicted_means(ranks, ridx, sid)
            S.clock[ridx] = new_clock
            S.skipped[ridx] += 1
            S.path_exec[ridx] += tvec
            S.path_comm[ridx] += tvec
        S.path_kernels[ridx] += 1
        S.freq[ridx, sid] += 1
        S.seen[ridx, sid] = True

        # -- eager: aggregate_statistics across the channel ------------------
        if self._eager and comm.channel is not None:
            self._aggregate_statistics(comm)
        return new_clock

    def _coll_vote(self, ranks, ridx, sid) -> bool:
        """OR-reduced execute vote: True when some participant must still
        execute (once-per-iteration) or too few deem the kernel
        predictable."""
        S = self.state
        if S.skip_ok[ridx, sid].all():
            return False         # every participant's skip vote is memoized
        itex = S.iter_exec[ridx, sid]
        if self._once and not itex.all():
            if self.extrapolator is None or not self._extrapolatable(sid):
                return True
            # never-executed kernels with a validated family model are
            # exempt from the once-per-iteration re-execution
            for i, r in enumerate(ranks):
                if not itex[i] and not self._never_ran(r, sid):
                    return True
        # count predictable participants; execute unless enough of the
        # channel deems the kernel predictable (early exit both ways)
        thr = self._vote_frac * len(ranks)
        n_pred = 0
        left = len(ranks)
        for r in ranks:
            left -= 1
            if self.predictable(r, sid):
                n_pred += 1
                if n_pred >= thr:
                    break
            elif n_pred + left < thr:
                return True
        if n_pred < thr:
            return True
        # skip: memoize each participant's vote that holds at count 1 so the
        # steady state takes the vectorized all() fast path above
        if self._vote_frac >= 1.0:
            tol, ms = self._tol, self._ms
            for r in ranks:
                stats = S.kbar[r].get(sid)
                if stats is not None and stats.n > 0 \
                        and stats.is_predictable(tol, 1, ms):
                    S.skip_ok[r, sid] = True
        return False

    def _predicted_means(self, ranks, ridx, sid):
        """Per-participant predicted mean, vectorized via the mean mirror
        (scalar when a globally-agreed statistic exists)."""
        g = self.global_stats.get(sid)
        if g is not None:
            return g.mean
        tvec = self.state.mean_arr[ridx, sid]
        nan = np.isnan(tvec)
        if nan.any():
            fill = 0.0
            if self.extrapolator is not None:
                pred = self._extrap_predict(sid)
                if pred is not None:
                    fill = pred[0]
            tvec = np.where(nan, fill, tvec)
        return tvec

    def _aggregate_statistics(self, comm):
        """Figure 2's kernel-aggregation loop at blocking collectives: every
        kernel in the participants' local sets that is deemed predictable and
        has not yet been propagated along this channel has its statistics
        merged and installed on all participants, and the channel is recorded
        in the kernel's propagated set (K[i].agg_channels).  A kernel is
        switched off globally once its propagated channels contain an
        aggregate spanning the world communicator."""
        S = self.state
        ranks = comm.ranks
        chash = comm.channel.hash_id
        global_off = self.global_off
        # candidate kernels: predictable on >= 1 participant, not yet
        # propagated along this channel.  The scan walks each participant's
        # pred_live dirty set (maintained at every statistics write, see
        # _note_stats) instead of its whole K-bar; sids switched off
        # globally since their last write are evicted lazily here.
        candset = set()
        for r in ranks:
            live = S.pred_live[r]
            if not live:
                continue
            agg_r = S.agg_channels[r]
            stale = None
            for sid in live:
                if sid in global_off:
                    if stale is None:
                        stale = []
                    stale.append(sid)
                    continue
                chans = agg_r.get(sid)
                if chans is not None and chash in chans:
                    continue
                candset.add(sid)
            if stale:
                live.difference_update(stale)
        # per-sid merges are independent, so candidate order cannot affect
        # the result; sort anyway for a deterministic event stream
        for sid in sorted(candset):
            merged = KernelStats()
            for r in ranks:
                stats = S.kbar[r].get(sid)
                if stats is not None:
                    merged.merge(stats)
            covered = False
            for r in ranks:
                inst = S.kbar[r][sid] = merged.copy()
                S.mean_arr[r, sid] = merged.mean
                S.skip_ok[r, sid] = False       # statistics changed
                self._note_stats(r, sid, inst)
                agg_r = S.agg_channels[r]
                chans = agg_r.get(sid)
                if chans is None:
                    chans = agg_r[sid] = set()
                chans.add(chash)
                if not covered:
                    covered = self.registry.covers_world(chans)
            if covered or comm.size == self.world.size:
                global_off.add(sid)
                self.global_stats[sid] = merged
                S.goff[sid] = True
                S.gmean[sid] = merged.mean

    # ---------------------------------------------------------- point-to-point

    def p2p_vote(self, rank: int, sid: int) -> bool:
        """The sender-or-receiver-local execute vote (int_msg.execute)."""
        S = self.state
        if sid >= S.cap:
            S.ensure(sid)
        if self.force_execute:
            return True
        if S.skip_ok[rank, sid]:        # memoized skip verdict
            return False
        if sid in self.global_off:
            return False
        return not self._skip_verdict(rank, sid)

    def on_p2p(self, src: int, dst: int, sid: int, sampler,
               src_vote: bool, overhead: float = 0.0) -> float:
        """Complete a matched BLOCKING Send/Recv pair (MPI_Recv interception:
        internal PMPI_Sendrecv of int_msgs, max of the two paths, OR of the
        execute votes).  Both clocks synchronize (rendezvous).

        Returns the shared post-completion clock."""
        S = self.state
        if sid >= S.cap:
            S.ensure(sid)
        execute = src_vote or self.p2p_vote(dst, sid)

        # longest path wins
        pe = S.path_exec
        winner, loser = (src, dst) if pe[src] > pe[dst] else (dst, src)
        if self._propagates:
            wseen = S.seen[winner]
            np.copyto(S.freq[loser], S.freq[winner], where=wseen)
            S.seen[loser] |= wseen
        pe[loser] = pe[winner]
        S.path_comp[loser] = S.path_comp[winner]
        S.path_comm[loser] = S.path_comm[winner]
        S.path_kernels[loser] = S.path_kernels[winner]

        clock = S.clock
        base = max(clock[src], clock[dst]) + overhead
        if execute:
            t = sampler(self._sigs[sid])
            done = base + t
            for r in (src, dst):
                if self.update_stats:
                    stats = S.stats(r, sid)
                    stats.update(t)
                    S.mean_arr[r, sid] = stats.mean
                    S.skip_ok[r, sid] = False   # statistics changed
                    if self._eager:
                        self._note_stats(r, sid, stats)
                S.iter_exec[r, sid] = True
                S.measured_time[r] += t
                S.executed[r] += 1
                self._charge_comm(r, sid, t)
        else:
            done = base
            for r in (src, dst):
                S.skipped[r] += 1
                self._charge_comm(r, sid, self._predicted_mean(r, sid))
        clock[src] = done
        clock[dst] = done
        return done

    def on_isend_match(self, src: int, dst: int, sid: int, sampler,
                       src_vote: bool, snapshot, overhead: float = 0.0):
        """Complete a buffered Isend matched by a Recv (MPI_Recv + MPI_Wait
        interception).  ``snapshot`` is (path_tuple, freqs_or_None,
        post_clock) captured when the Isend was posted — the internal
        message travels with the SENDER'S PATH AT POST TIME; the sender's
        own state is not rewound (it has moved on), but its statistics ARE
        updated with the completion sample (Figure 2's MPI_Wait update)."""
        S = self.state
        if sid >= S.cap:
            S.ensure(sid)
        (p_exec, p_comp, p_comm, p_kc), post_freqs, post_clock = snapshot
        execute = src_vote or self.p2p_vote(dst, sid)

        # receiver adopts the deposited path if it dominates
        if p_exec > S.path_exec[dst]:
            if self._propagates and post_freqs is not None:
                # post_freqs is the sender's freq row at post time; transfer
                # the nonzero counts (the row may be shorter than the
                # current capacity if new signatures appeared since)
                m = post_freqs.shape[0]
                mask = post_freqs > 0
                np.copyto(S.freq[dst, :m], post_freqs, where=mask)
                S.seen[dst, :m] |= mask
            S.path_exec[dst] = p_exec
            S.path_comp[dst] = p_comp
            S.path_comm[dst] = p_comm
            S.path_kernels[dst] = p_kc

        base = max(post_clock, S.clock[dst]) + overhead
        if execute:
            t = sampler(self._sigs[sid])
            done = base + t
            for r in (src, dst):
                if self.update_stats:
                    stats = S.stats(r, sid)
                    stats.update(t)
                    S.mean_arr[r, sid] = stats.mean
                    S.skip_ok[r, sid] = False   # statistics changed
                    if self._eager:
                        self._note_stats(r, sid, stats)
                S.iter_exec[r, sid] = True
                S.executed[r] += 1
            S.measured_time[dst] += t
            self._charge_comm(dst, sid, t)
        else:
            done = base
            S.skipped[src] += 1
            S.skipped[dst] += 1
            self._charge_comm(dst, sid, self._predicted_mean(dst, sid))
        S.clock[dst] = done
        return done

    def _charge_comm(self, rank: int, sid: int, t: float):
        S = self.state
        S.path_exec[rank] += t
        S.path_comm[rank] += t
        S.path_kernels[rank] += 1
        S.freq[rank, sid] += 1
        S.seen[rank, sid] = True

    def isend_snapshot(self, rank: int):
        """Capture the sender-side internal message payload at post time."""
        S = self.state
        # freq-row copy: the seed kept {sig: freq if freq} — transferring
        # only nonzero counts is deferred to the (rarer) adoption at match
        freqs = S.freq[rank].copy() if self._propagates else None
        path = (float(S.path_exec[rank]), float(S.path_comp[rank]),
                float(S.path_comm[rank]), int(S.path_kernels[rank]))
        return (path, freqs, float(S.clock[rank]))

    # ----------------------------------------------------------------- report

    def report(self) -> IterationReport:
        S = self.state
        ex = int(S.executed.sum())
        sk = int(S.skipped.sum())
        return IterationReport(
            float(S.path_exec.max()), float(S.clock.max()),
            float(S.path_comp.max()), float(S.path_comm.max()),
            float(S.measured_time.max()), float(S.measured_comp.max()),
            ex, sk, ex + sk)
