"""The discrete-event engine.

Runs one *tuning iteration* (one benchmark execution of one configuration):
every virtual rank executes its generator program; computation kernels are
handled inline; communications block until matched; each interception point
invokes the Critter protocol (core.critter), which advances per-rank clocks
and path profiles and makes the selective-execution decision.

Matching semantics:

- collectives match by per-communicator arrival index (the k-th collective
  a rank posts on communicator C completes with every other rank's k-th);
  a mismatch in op kind OR byte count across participants is a schedule bug
  and raises;
- blocking Send/Recv are rendezvous; Isend is buffered (deposits a snapshot
  of the sender's path profile, sender proceeds); Recv matches Send/Isend
  in post order per (src, dst, tag);
- Wait on an Isend request is an interception no-op (buffered completion).

If no rank can make progress before all programs finish, DeadlockError
reports the blocked ranks and what they wait on.

Hot-path design (see also core.critter):

- **signature interning**: every op resolves its Signature to a dense
  integer id once, cached on the op instance (ops are reused via trace
  replay), so the per-event cost is an attribute read instead of a
  dataclass hash;
- **record/replay split**: rank programs are generators whose op streams do
  not depend on engine feedback (the only value sent back is the opaque
  Isend handle, consumed by Wait), and communication matching in this
  engine is purely structural — independent of sampled times.  The
  interleaved sequence of Critter interceptions is therefore identical
  across iterations of one configuration, so the first execution of a
  program factory runs a *structural recording pass* (generators, matching
  queues, scheduler — no Critter, no RNG) that emits a flat event program;
  every iteration, including the first, then executes that program through
  an interpreter, skipping generators and matching entirely on all
  subsequent iterations (the common case — the tuner runs trials-many
  iterations per configuration).  Runs of consecutive computation kernels
  of one rank are fused into blocks that the profiler can charge in one
  vectorized step.  Pass ``trace_cache=False`` for programs whose op
  stream is nondeterministic or feedback-dependent; that path interleaves
  recording-free matching with scalar interception exactly like the seed
  engine;
- **batched cold runs**: forced (recording/reference) executions sample
  every kernel, so the cold interpreter pre-splits the event program into
  *segments* bounded by RNG-consuming communication events and draws each
  segment's computation-kernel samples in one vectorized call when the
  cost model supports it (``CostModel.batch_info``: lognormal noise with
  the straggler branch off), falling back to per-event scalar draws — the
  same calls in the same order — when it does not.  Charging is batched
  per fused block (``Critter.on_comp_block_cold``) with sequential
  float accumulation, so path metrics, statistics, and the sampler RNG
  stream stay bit-identical to the scalar path;
- **runnable queue**: first-run scheduling pops a (sweep, rank) heap
  instead of scanning all ranks per pass, preserving the exact round-robin
  order of the seed engine (a rank unblocked by a lower-ranked completer
  runs in the same sweep; one unblocked by a higher-ranked completer runs
  in the next), which keeps sampler RNG consumption — and therefore
  results — bit-identical.
"""

from __future__ import annotations

import weakref
from collections import deque
from heapq import heappop, heappush
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.critter import Critter, IterationReport
from repro_torch.core.signatures import Signature, comm_sig, comp_sig, p2p_sig
from .comm import World
from .ops import (CS_BLOCK, CS_COLL, CS_COMP, CS_IMATCH, CS_IPOST, CS_P2P,
                  EV_BLOCK, EV_COLL, EV_COMP, EV_IMATCH, EV_IPOST, EV_P2P,
                  KIND_COLL, KIND_COMP, KIND_ISEND, KIND_RECV, KIND_SEND,
                  KIND_WAIT)
from .program import (CompBlock, ColdProgram, EventProgram, ProgramCache,
                      WarmProgram, build_cold, build_warm, compile_events)

# compiled-program containers and lowering passes live in .program (PR 10:
# programs are serializable, cacheable artifacts); the historical private
# names stay importable for the bench/test harnesses
_CompBlock = CompBlock
_EventProgram = EventProgram
_WarmProgram = WarmProgram
_ColdProgram = ColdProgram

RUNNABLE, BLOCKED, DONE = 0, 1, 2


class DeadlockError(RuntimeError):
    pass


class RunResult(IterationReport):

    @classmethod
    def from_report(cls, rep: IterationReport) -> "RunResult":
        return cls(rep.predicted_time, rep.wall_time, rep.crit_comp,
                   rep.crit_comm, rep.measured_time, rep.max_measured_comp,
                   rep.executed, rep.skipped, rep.events)


class _CollSite:
    __slots__ = ("op", "nbytes", "arrived", "needed", "sig_id")

    def __init__(self, op, nbytes, needed, sig_id):
        self.op = op
        self.nbytes = nbytes
        self.arrived: List[int] = []
        self.needed = needed
        self.sig_id = sig_id


class Runtime:
    """One World + one Critter profiler + a timing source."""

    def __init__(self, world: World, critter: Critter,
                 timer: Callable[[Signature, np.random.Generator], float],
                 *, seed: int = 0, overhead: float = 1e-6,
                 trace_cache: bool = True, compiled: bool = True,
                 program_cache: Optional[ProgramCache] = None):
        self.world = world
        self.critter = critter
        self.timer = timer
        self.overhead = overhead
        self.trace_cache = trace_cache
        # cross-Runtime event-program cache (see .program): consulted for
        # factories that carry a ``program_key`` structural fingerprint;
        # a hit materializes the recorded program into this World and
        # skips ``_record`` entirely
        self.program_cache = program_cache
        # compiled selective replay (Critter.run_warm over the segmented
        # warm program).  Bit-identical to the plain event interpreter;
        # ``compiled=False`` forces the scalar warm path (the bench harness
        # measures the compiled speedup against it)
        self.compiled = compiled
        self._rng = np.random.default_rng(seed)
        self._intern = world.interner.intern
        self._sig_cache: Dict[tuple, int] = {}
        # batched cold-run sampling: available when the timer is a bound
        # method of an object exposing ``batch_info(sigs) -> (det, sigma)
        # | None`` (CostModel); anything else falls back to per-event
        # scalar draws, which preserve the RNG stream by construction
        timer_obj = getattr(timer, "__self__", None)
        self._batch_info = getattr(timer_obj, "batch_info", None)
        # counter-RNG batched sampling (CostModel.sample_block): vectorizes
        # the whole draw sequence even with the straggler branch on — the
        # counter discipline gives every event fixed draw slots, so there
        # is no scalar fallback left to pay
        self._sample_block = getattr(timer_obj, "sample_block", None)
        # program_factory -> compiled event program (weak: dies with the
        # configuration's program factory) — the fallback identity-keyed
        # map for factories without a structural fingerprint
        self._traces = weakref.WeakKeyDictionary()
        # structural fingerprint -> compiled event program (strong: equal
        # geometries share one program even when their factory objects are
        # distinct or short-lived)
        self._keyed: Dict[str, EventProgram] = {}
        # observability: recordings counts actual structural passes;
        # cache_hits/misses count program_cache consultations (fingerprint
        # -keyed factories only)
        self.recordings = 0
        self.cache_hits = 0
        self.cache_misses = 0

    # -- signature interning (hot path) --------------------------------------

    def _comp_sid(self, name, params) -> int:
        key = (0, name, params)
        sid = self._sig_cache.get(key)
        if sid is None:
            sid = self._intern(comp_sig(name, *params))
            self._sig_cache[key] = sid
        return sid

    def _coll_sid(self, op, comm, nbytes) -> int:
        key = (1, op, comm.size, comm.stride, nbytes)
        sid = self._sig_cache.get(key)
        if sid is None:
            sid = self._intern(comm_sig(op, nbytes, comm.size, comm.stride))
            self._sig_cache[key] = sid
        return sid

    def _p2p_sid(self, name, nbytes) -> int:
        key = (2, name, nbytes)
        sid = self._sig_cache.get(key)
        if sid is None:
            sid = self._intern(p2p_sig(name, nbytes))
            self._sig_cache[key] = sid
        return sid

    # -- structural recording pass --------------------------------------------

    def _record(self, program_factory) -> list:
        """Run the rank generators to exhaustion, matching communication
        structurally, and record the flat interception sequence WITHOUT
        invoking the Critter protocol or consuming sampler RNG.

        Matching is independent of sampled times, so the recorded program
        replayed through the interpreters produces interceptions (and RNG
        consumption) bit-identical to the historical interleaved pass.  A
        deadlock or collective mismatch therefore raises before any
        profiler state is touched.

        KEEP IN SYNC with ``_run_live``: both implement the same
        structural matching semantics (collective site validation, p2p
        queues, heap sweeps, deadlock reporting); this copy exists so the
        recording pass pays zero interception branches per op.  Any
        change to matching must land in both; tests/test_cold_path.py and
        tests/test_golden_reports.py pin their equivalence."""
        world = self.world
        n = world.size
        gens = [program_factory(r, world) for r in range(n)]
        events: list = []
        append = events.append
        status = [RUNNABLE] * n
        blocked_on: List[Optional[object]] = [None] * n
        coll_sites: Dict[Tuple[int, int], _CollSite] = {}
        coll_counts: Dict[Tuple[int, int], int] = {}
        # send entry: (sender_rank, sig_id, slot_or_None); None = rendezvous
        sends: Dict[tuple, deque] = {}
        recvs: Dict[tuple, deque] = {}
        state = [0, 0, n]        # isend slot counter, next handle, live

        def advance(r, sweep, value=None):
            """Run rank r until it blocks or finishes."""
            gen = gens[r]
            while True:
                try:
                    op = gen.send(value)
                except StopIteration:
                    status[r] = DONE
                    state[2] -= 1
                    return
                value = None
                k = op.KIND
                if k == KIND_COMP:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._comp_sid(op.name, op.params)
                    append((EV_COMP, r, sid))
                    continue
                if k == KIND_COLL:
                    comm = op.comm
                    key = (comm.id, r)
                    idx = coll_counts.get(key, 0)
                    coll_counts[key] = idx + 1
                    skey = (comm.id, idx)
                    site = coll_sites.get(skey)
                    if site is None:
                        sid = op.sig_id
                        if sid is None:
                            sid = op.sig_id = \
                                self._coll_sid(op.op, comm, op.nbytes)
                        site = _CollSite(op.op, op.nbytes, comm.size, sid)
                        coll_sites[skey] = site
                    elif site.op != op.op:
                        raise RuntimeError(
                            f"collective mismatch on comm {comm.id} site {idx}:"
                            f" {site.op} vs {op.op} (rank {r})")
                    elif site.nbytes != op.nbytes:
                        raise RuntimeError(
                            f"collective byte-count mismatch on comm "
                            f"{comm.id} site {idx} ({site.op}): "
                            f"{site.nbytes}B vs {op.nbytes}B (rank {r})")
                    site.arrived.append(r)
                    if len(site.arrived) < site.needed:
                        status[r] = BLOCKED
                        blocked_on[r] = op
                        return
                    del coll_sites[skey]
                    append((EV_COLL, site.sig_id, comm))
                    for rr in site.arrived:
                        if rr != r:
                            status[rr] = RUNNABLE
                            blocked_on[rr] = None
                            heappush(heap,
                                     (sweep if rr > r else sweep + 1, rr))
                    continue
                if k == KIND_SEND:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._p2p_sid("send", op.nbytes)
                    pkey = (r, op.dst, op.tag)
                    q = recvs.get(pkey)
                    if q:
                        q.popleft()
                        append((EV_P2P, r, op.dst, sid))
                        dst = op.dst
                        status[dst] = RUNNABLE
                        blocked_on[dst] = None
                        heappush(heap,
                                 (sweep if dst > r else sweep + 1, dst))
                        continue
                    sends.setdefault(pkey, deque()).append((r, sid, None))
                    status[r] = BLOCKED
                    blocked_on[r] = op
                    return
                if k == KIND_RECV:
                    pkey = (op.src, r, op.tag)
                    q = sends.get(pkey)
                    if q:
                        src, sid, slot = q.popleft()
                        if slot is None:   # blocking sender, rendezvous
                            append((EV_P2P, src, r, sid))
                            status[src] = RUNNABLE
                            blocked_on[src] = None
                            heappush(heap,
                                     (sweep if src > r else sweep + 1, src))
                        else:              # buffered isend
                            append((EV_IMATCH, src, r, sid, slot))
                        continue
                    recvs.setdefault(pkey, deque()).append(r)
                    status[r] = BLOCKED
                    blocked_on[r] = op
                    return
                if k == KIND_ISEND:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._p2p_sid("send", op.nbytes)
                    slot = state[0]
                    state[0] = slot + 1
                    append((EV_IPOST, r, sid, slot))
                    pkey = (r, op.dst, op.tag)
                    q = recvs.get(pkey)
                    if q:
                        rcv = q.popleft()
                        append((EV_IMATCH, r, rcv, sid, slot))
                        status[rcv] = RUNNABLE
                        blocked_on[rcv] = None
                        heappush(heap,
                                 (sweep if rcv > r else sweep + 1, rcv))
                    else:
                        sends.setdefault(pkey, deque()).append((r, sid, slot))
                    state[1] += 1
                    value = state[1]
                    continue
                if k == KIND_WAIT:
                    continue
                raise TypeError(f"rank {r} yielded unknown op {op!r}")

        heap: List[Tuple[int, int]] = [(0, r) for r in range(n)]
        while heap:
            sweep, r = heappop(heap)
            if status[r] == RUNNABLE:
                advance(r, sweep)
        if state[2] > 0:
            blocked = [(r, blocked_on[r]) for r in range(n)
                       if status[r] == BLOCKED]
            if blocked:
                detail = ", ".join(f"rank {r}: {op!r}"
                                   for r, op in blocked[:8])
                raise DeadlockError(
                    f"{len(blocked)} ranks blocked with no progress: "
                    f"{detail}")
        self.recordings += 1
        return events

    # -- event-program compilation --------------------------------------------

    # the lowering passes live in .program (they are pure functions of the
    # event list + the World's interner table); these wrappers keep the
    # historical call sites — and the bench/test harnesses poking them —
    # working unchanged
    _compile_events = staticmethod(compile_events)

    def _build_cold(self, prog: EventProgram) -> ColdProgram:
        return build_cold(prog, self.world.interner.sigs)

    def _build_warm(self, prog: EventProgram) -> WarmProgram:
        return build_warm(prog, self.world.interner.sigs)

    def warm_meta(self, program_factory) -> dict:
        """Segmentation statistics of the compiled warm program for
        ``program_factory`` (recording + compiling it if needed) — consumed
        by the bench harness and the CI engine gate."""
        prog = self._get_program(program_factory)
        warm = prog.warm
        if warm is None:
            warm = prog.warm = self._build_warm(prog)
        return dict(warm.meta)

    # -- interpreters ---------------------------------------------------------

    def _run_events(self, prog: _EventProgram, sampler) -> None:
        """Execute a compiled event program: the scheduler, matching queues
        and generators are gone; only the interception sequence remains."""
        critter = self.critter
        overhead = self.overhead
        on_comp = critter.on_comp
        on_comp_block = critter.on_comp_block
        on_coll = critter.on_coll
        on_p2p = critter.on_p2p
        on_isend_match = critter.on_isend_match
        p2p_vote = critter.p2p_vote
        isend_snapshot = critter.isend_snapshot
        slots: List[Optional[tuple]] = [None] * prog.n_slots
        for ev in prog.events:
            k = ev[0]
            if k == EV_COMP:
                on_comp(ev[1], ev[2], sampler)
            elif k == EV_IPOST:
                slots[ev[3]] = (p2p_vote(ev[1], ev[2]),
                                isend_snapshot(ev[1]))
            elif k == EV_IMATCH:
                vote, snapshot = slots[ev[4]]
                on_isend_match(ev[1], ev[2], ev[3], sampler, vote, snapshot,
                               overhead)
            elif k == EV_P2P:
                on_p2p(ev[1], ev[2], ev[3], sampler,
                       p2p_vote(ev[1], ev[3]), overhead)
            elif k == EV_BLOCK:
                on_comp_block(ev[1], ev[2], sampler)
            else:
                on_coll(ev[1], ev[2], sampler, overhead)

    def _run_events_cold(self, cold: _ColdProgram) -> None:
        """Execute a cold program under force_execute.

        When the cost model batches, every sample of the run — computation
        AND communication — is drawn up front in one vectorized call and
        each step consumes its precomputed time at a running cursor;
        otherwise each sampling step draws through the scalar timer at its
        own position, which is the same call sequence as the interleaved
        seed engine.  All interceptions go through the force-specialized
        ``*_cold`` Critter methods, which operate on list-backed per-rank
        scalar mirrors for the duration of the run (``begin_cold`` ..
        ``finish_cold``) — NumPy scalar indexing dominates the p2p-heavy
        hot path otherwise, particularly under the scalar-fallback draws
        of straggler-enabled cost models."""
        critter = self.critter
        critter.state.ensure(cold.max_sid)
        critter.begin_cold()
        rng = self._rng
        timer = self.timer
        overhead = self.overhead
        on_comp_cold = critter.on_comp_cold
        on_comp_block_cold = critter.on_comp_block_cold
        on_coll_cold = critter.on_coll_cold
        on_p2p_cold = critter.on_p2p_cold
        on_isend_match_cold = critter.on_isend_match_cold
        isend_snapshot_cold = critter.isend_snapshot_cold
        slots: List[Optional[tuple]] = [None] * cold.n_slots

        ts = None
        if self._sample_block is not None and cold.draw_sigs:
            # counter-RNG batching: the whole draw sequence — stragglers
            # included — in one vectorized pass (no cache: the draw cursor
            # advances per run).  None when the model is not in counter
            # mode; fall through to the legacy batch/scalar paths.
            drawn = self._sample_block(cold.draw_sigs)
            if drawn is not None:
                ts = drawn.tolist()
        if ts is None:
            info = cold.batch
            if info is None:
                info = False
                if self._batch_info is not None and cold.draw_sigs:
                    bi = self._batch_info(cold.draw_sigs)
                    if bi is not None:
                        info = bi
                cold.batch = info
            if info is not False:
                det, sigma = info
                ts = (det * np.exp(
                    sigma * rng.standard_normal(len(det)))).tolist()
        cur = 0

        for st in cold.steps:
            k = st[0]
            if k == CS_COMP:
                if ts is None:
                    t = timer(st[3], rng)
                else:
                    t = ts[cur]
                    cur += 1
                on_comp_cold(st[1], st[2], t)
            elif k == CS_IPOST:
                slots[st[2]] = isend_snapshot_cold(st[1])
            elif k == CS_IMATCH:
                if ts is None:
                    t = timer(st[5], rng)
                else:
                    t = ts[cur]
                    cur += 1
                on_isend_match_cold(st[1], st[2], st[3], t, slots[st[4]],
                                    overhead)
            elif k == CS_BLOCK:
                block = st[2]
                if ts is None:
                    tsl = [timer(sig, rng) for sig in st[3]]
                else:
                    end = cur + block.n
                    tsl = ts[cur:end]
                    cur = end
                on_comp_block_cold(st[1], block, tsl)
            elif k == CS_P2P:
                if ts is None:
                    t = timer(st[4], rng)
                else:
                    t = ts[cur]
                    cur += 1
                on_p2p_cold(st[1], st[2], st[3], t, overhead)
            else:
                if ts is None:
                    t = timer(st[3], rng)
                else:
                    t = ts[cur]
                    cur += 1
                on_coll_cold(st[1], st[2], t, overhead)
        critter.finish_cold(cold.exec_rows, cold.exec_cols)

    # -- main loop ------------------------------------------------------------

    def run(self, program_factory, *, force_execute: bool = False,
            update_stats: bool = True) -> RunResult:
        critter = self.critter
        critter.begin_iteration(force_execute=force_execute,
                                update_stats=update_stats)
        rng = self._rng
        timer = self.timer
        sampler = lambda sig: timer(sig, rng)  # noqa: E731

        if not self.trace_cache:
            self._run_live(program_factory, sampler)
            return RunResult.from_report(critter.report())

        prog = self._get_program(program_factory)
        if force_execute:
            cold = prog.cold
            if cold is None:
                cold = prog.cold = self._build_cold(prog)
            self._run_events_cold(cold)
        elif self.compiled and critter.warm_eligible():
            warm = prog.warm
            if warm is None:
                warm = prog.warm = self._build_warm(prog)
            critter.run_warm(warm, sampler, self.overhead)
        else:
            self._run_events(prog, sampler)
        return RunResult.from_report(critter.report())

    def _get_program(self, program_factory) -> EventProgram:
        # fingerprint-keyed path: factories stamped with a structural
        # fingerprint (``program_key``) share programs across equal
        # geometries in-process and, when a ProgramCache is configured,
        # across Runtimes / processes / runs
        key = getattr(program_factory, "program_key", None)
        if key is not None:
            prog = self._keyed.get(key)
            if prog is not None:
                return prog
            cache = self.program_cache
            if cache is not None:
                prog = cache.get(key, self.world)
                if prog is not None:
                    self.cache_hits += 1
                    self._keyed[key] = prog
                    return prog
                self.cache_misses += 1
            prog = self._record_keyed(key, program_factory)
            self._keyed[key] = prog
            return prog
        try:
            prog = self._traces.get(program_factory)
        except TypeError:            # unhashable/unweakrefable factory
            prog = None
        if prog is None:
            prog = compile_events(self._record(program_factory))
            try:
                self._traces[program_factory] = prog
            except TypeError:
                pass
        return prog

    def _record_keyed(self, key: str, program_factory) -> EventProgram:
        """Record + compile under a structural fingerprint, publishing to
        the configured ProgramCache.  The World's communicator-creation
        delta is captured around the recording pass and stored with the
        artifact so a loading World replays the same creations in the same
        order (channel-registry aggregates are order-sensitive — see
        .program's bit-identity contract)."""
        n_comms = len(self.world._comms)
        prog = compile_events(self._record(program_factory))
        if self.program_cache is not None:
            new_comms = list(self.world._comms)[n_comms:]
            self.program_cache.put(key, prog, self.world, comms=new_comms)
        return prog

    def adopt_program(self, key: str, prog: EventProgram) -> None:
        """Inject a pre-recorded program under a structural fingerprint:
        subsequent runs of factories stamped with ``program_key == key``
        skip ``_record`` entirely.  The program must have been materialized
        into (or recorded in) THIS Runtime's World — sids are World-local."""
        self._keyed[key] = prog

    def _run_live(self, program_factory, sampler) -> None:
        """The seed engine's interleaved pass (``trace_cache=False``):
        generators, structural matching, and scalar Critter interception in
        one loop, nothing recorded.  Kept for programs whose op streams are
        nondeterministic or feedback-dependent — and as the reference
        implementation the recorded paths are pinned against
        (tests/test_cold_path.py, tests/test_golden_reports.py).

        KEEP IN SYNC with ``_record``: same structural matching semantics,
        see the note there."""
        world = self.world
        critter = self.critter
        overhead = self.overhead
        n = world.size
        gens = [program_factory(r, world) for r in range(n)]
        isend_slots = [0]
        status = [RUNNABLE] * n
        blocked_on: List[Optional[object]] = [None] * n
        # collective sites: (comm.id, site_index) -> _CollSite
        coll_sites: Dict[Tuple[int, int], _CollSite] = {}
        coll_counts: Dict[Tuple[int, int], int] = {}
        # p2p queues: (src, dst, tag) -> deque of entries
        # send entry: (sender_rank, sig_id, vote, snapshot_or_None, slot)
        sends: Dict[tuple, deque] = {}
        recvs: Dict[tuple, deque] = {}
        next_handle = [0]
        # runnable queue: (sweep, rank) min-heap reproducing the seed
        # engine's sorted round-robin sweeps exactly
        heap: List[Tuple[int, int]] = [(0, r) for r in range(n)]

        live = [n]

        def advance(r, sweep, value=None):
            """Run rank r until it blocks or finishes."""
            gen = gens[r]
            while True:
                try:
                    op = gen.send(value)
                except StopIteration:
                    status[r] = DONE
                    live[0] -= 1
                    return
                value = None
                k = op.KIND
                if k == KIND_COMP:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._comp_sid(op.name, op.params)
                    critter.on_comp(r, sid, sampler)
                    continue
                if k == KIND_COLL:
                    comm = op.comm
                    key = (comm.id, r)
                    idx = coll_counts.get(key, 0)
                    coll_counts[key] = idx + 1
                    skey = (comm.id, idx)
                    site = coll_sites.get(skey)
                    if site is None:
                        sid = op.sig_id
                        if sid is None:
                            sid = op.sig_id = \
                                self._coll_sid(op.op, comm, op.nbytes)
                        site = _CollSite(op.op, op.nbytes, comm.size, sid)
                        coll_sites[skey] = site
                    elif site.op != op.op:
                        raise RuntimeError(
                            f"collective mismatch on comm {comm.id} site {idx}:"
                            f" {site.op} vs {op.op} (rank {r})")
                    elif site.nbytes != op.nbytes:
                        raise RuntimeError(
                            f"collective byte-count mismatch on comm "
                            f"{comm.id} site {idx} ({site.op}): "
                            f"{site.nbytes}B vs {op.nbytes}B (rank {r})")
                    site.arrived.append(r)
                    if len(site.arrived) < site.needed:
                        status[r] = BLOCKED
                        blocked_on[r] = op
                        return
                    # complete the collective
                    del coll_sites[skey]
                    critter.on_coll(site.sig_id, comm, sampler, overhead)
                    for rr in site.arrived:
                        if rr != r:
                            status[rr] = RUNNABLE
                            blocked_on[rr] = None
                            heappush(heap,
                                     (sweep if rr > r else sweep + 1, rr))
                    continue
                if k == KIND_SEND:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._p2p_sid("send", op.nbytes)
                    pkey = (r, op.dst, op.tag)
                    q = recvs.get(pkey)
                    if q:
                        q.popleft()
                        vote = critter.p2p_vote(r, sid)
                        critter.on_p2p(r, op.dst, sid, sampler, vote,
                                       overhead)
                        dst = op.dst
                        status[dst] = RUNNABLE
                        blocked_on[dst] = None
                        heappush(heap,
                                 (sweep if dst > r else sweep + 1, dst))
                        continue
                    sends.setdefault(pkey, deque()).append(
                        (r, sid, None, None, 0))
                    status[r] = BLOCKED
                    blocked_on[r] = op
                    return
                if k == KIND_RECV:
                    pkey = (op.src, r, op.tag)
                    q = sends.get(pkey)
                    if q:
                        src, sid, vote, snapshot, slot = q.popleft()
                        if snapshot is None:   # blocking sender, rendezvous
                            vote = critter.p2p_vote(src, sid)
                            critter.on_p2p(src, r, sid, sampler, vote,
                                           overhead)
                            status[src] = RUNNABLE
                            blocked_on[src] = None
                            heappush(heap,
                                     (sweep if src > r else sweep + 1, src))
                        else:                  # buffered isend
                            critter.on_isend_match(src, r, sid, sampler,
                                                   vote, snapshot, overhead)
                        continue
                    recvs.setdefault(pkey, deque()).append(r)
                    status[r] = BLOCKED
                    blocked_on[r] = op
                    return
                if k == KIND_ISEND:
                    sid = op.sig_id
                    if sid is None:
                        sid = op.sig_id = self._p2p_sid("send", op.nbytes)
                    slot = isend_slots[0]
                    isend_slots[0] = slot + 1
                    vote = critter.p2p_vote(r, sid)
                    snapshot = critter.isend_snapshot(r)
                    pkey = (r, op.dst, op.tag)
                    q = recvs.get(pkey)
                    if q:
                        rcv = q.popleft()
                        critter.on_isend_match(r, rcv, sid, sampler, vote,
                                               snapshot, overhead)
                        status[rcv] = RUNNABLE
                        blocked_on[rcv] = None
                        heappush(heap,
                                 (sweep if rcv > r else sweep + 1, rcv))
                    else:
                        sends.setdefault(pkey, deque()).append(
                            (r, sid, vote, snapshot, slot))
                    next_handle[0] += 1
                    value = next_handle[0]
                    continue
                if k == KIND_WAIT:
                    # buffered isend: completion is free; the interception
                    # point exists but statistics were updated at match time
                    continue
                raise TypeError(f"rank {r} yielded unknown op {op!r}")

        while heap:
            sweep, r = heappop(heap)
            if status[r] == RUNNABLE:
                advance(r, sweep)
        if live[0] > 0:
            blocked = [(r, blocked_on[r]) for r in range(n)
                       if status[r] == BLOCKED]
            if blocked:
                detail = ", ".join(f"rank {r}: {op!r}"
                                   for r, op in blocked[:8])
                raise DeadlockError(
                    f"{len(blocked)} ranks blocked with no progress: "
                    f"{detail}")
