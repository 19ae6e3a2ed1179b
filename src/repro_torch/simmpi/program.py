"""Event programs as first-class, serializable artifacts.

The structural recording pass (``Runtime._record``) is RNG-free and
depends only on study geometry — not on policy, tolerance, or cost-model
sampling — so its product can be recorded once per unique geometry and
replayed everywhere: across configurations of one study, across the tasks
of a policy x tolerance sweep, across worker processes, and across runs
(via the on-disk store).  This module holds

- the compiled program containers, promoted out of ``Runtime``:
  ``EventProgram`` (the flat interception sequence + isend slot layout)
  with its lazily-derived ``ColdProgram`` (batched forced execution) and
  ``WarmProgram`` (segmented vectorized selective replay) segmentations,
  plus ``CompBlock`` fusion and the ``compile_events`` /
  ``build_cold`` / ``build_warm`` lowering passes;
- a versioned JSON serialization (``program_to_payload`` /
  ``program_from_payload``) that replaces live engine objects with stable
  keys and remaps interned signature ids across Worlds;
- ``structural_fingerprint``: the content address over
  (study key, world size, geometry params);
- ``ProgramCache``: in-process LRU + crash-atomic, crc32-validated
  on-disk store, with a LOUD fallback to re-recording on any version /
  fingerprint / checksum mismatch (a stale artifact must never be
  silently replayed as current).

Bit-identity across the cache boundary
--------------------------------------

A cache-hit run must be byte-identical to a cache-miss run: same reports,
same rank state, same sampler RNG stream.  Signature ids are dense
per-World intern-order integers and several float accumulations iterate
tables in sid order, so the payload stores the referenced signatures
sorted by their record-time sid and the loader re-interns them in that
order — a destination World that processes the same configurations in the
same order (the sweep/driver contract) therefore assigns the exact same
ids the recording World did.  Communicator *creation order* feeds the
channel registry's aggregate discovery (consumed by the eager policy's
``covers_world``), and generators may create communicators no event
references, so the payload also carries every communicator the recording
created, in creation order, and the loader replays those creations before
materializing events.  ``Comm.id`` (a process-global counter) is never
consumed by the interpreters and is allowed to differ.

The fingerprint is an identity over (study key, point name, geometry
params, world size) — the caller's contract is that those determine the
program structure, which holds for every study space in this repo (the
params dict carries the full geometry).  The on-disk artifact additionally
carries a crc32 over its canonical payload, so torn or corrupted files are
detected and re-recorded rather than trusted.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.critter import (W_BHEAD, W_BLOCK, W_CHEAD, W_COLL, W_COMP,
                                W_IMATCH, W_IPOST, W_P2P)
from repro_torch.core.signatures import Signature
from .ops import (CS_BLOCK, CS_COLL, CS_COMP, CS_IMATCH, CS_IPOST, CS_P2P,
                  EV_BLOCK, EV_COLL, EV_COMP, EV_IMATCH, EV_IPOST, EV_P2P)

#: artifact format version — bump on ANY change to the payload shape,
#: the EV_* opcode numbering, or the signature-table ordering contract;
#: a loader refuses (loudly) every other version and re-records
PROGRAM_VERSION = 1


class CompBlock:
    """A run of consecutive computation events of one rank, fused at event
    compilation: interned signature ids plus the unique-id/count arrays the
    profiler's vectorized skip path charges in one step."""

    __slots__ = ("sids", "sids_np", "uniq", "counts", "n", "max_sid",
                 "groups")

    def __init__(self, sids: List[int]):
        self.sids = sids
        self.sids_np = np.array(sids, dtype=np.intp)
        self.uniq, self.counts = np.unique(self.sids_np, return_counts=True)
        self.n = len(sids)
        self.max_sid = int(self.sids_np.max())
        # lazy per-unique-sid position lists (cold batched charging)
        self.groups: Optional[List[List[int]]] = None

    def group_indices(self) -> List[List[int]]:
        """Positions of each unique sid's samples within the block, in
        block order (so per-sid Welford updates see samples in the same
        order as per-event updates)."""
        g = self.groups
        if g is None:
            if len(self.uniq) == 1:
                g = [list(range(self.n))]
            else:
                g = [np.nonzero(self.sids_np == u)[0].tolist()
                     for u in self.uniq.tolist()]
            self.groups = g
        return g


# minimum run length worth a vectorized block (below this the fancy-index
# overhead exceeds the per-op savings)
MIN_BLOCK = 4


class EventProgram:
    """The flat interception sequence of one configuration run.

    events -- list of opcode tuples (see the EV_*/CS_* constants in .ops)
    n_slots -- number of isend post->match payload slots
    cold -- lazily-built batched cold-run program (ColdProgram)
    warm -- lazily-built compiled warm program (WarmProgram)
    """

    __slots__ = ("events", "n_slots", "cold", "warm")

    def __init__(self, events, n_slots):
        self.events = events
        self.n_slots = n_slots
        self.cold: Optional[ColdProgram] = None
        self.warm: Optional[WarmProgram] = None


class WarmProgram:
    """The event program segmented for the compiled selective interpreter
    (``Critter.run_warm``).

    entries -- list of W_* opcode tuples (see core.critter): one entry per
             interception, with each maximal per-rank run of computation
             events between that rank's skip-decision / communication
             boundaries marked by a W_CHEAD / W_BHEAD head entry carrying
             the segment metadata ``(sids, uniq, counts, n_events,
             n_member_entries)``
    n_slots -- isend post->match payload slots (same as the event program)
    max_sid -- highest signature id any entry touches (pre-grow capacity)
    meta -- segmentation statistics for the bench harness / CI gate:
             segment count, fused event count, batch-size distribution
    """

    __slots__ = ("entries", "n_slots", "max_sid", "meta")

    def __init__(self, entries, n_slots, max_sid, meta):
        self.entries = entries
        self.n_slots = n_slots
        self.max_sid = max_sid
        self.meta = meta


class ColdProgram:
    """The event program re-sliced for batched forced (cold) execution.

    A forced run samples EVERY kernel — computation and communication — in
    step order, so the whole run's draw sequence is known statically:
    ``draw_sigs`` lists the sampled signatures in consumption order (one
    per CS_COMP / CS_COLL / CS_P2P / CS_IMATCH step, ``block.n`` per
    CS_BLOCK step), and the interpreter walks ``steps`` with a running
    cursor into the draw buffer.  When the cost model can batch
    (``batch_info``: lognormal noise, straggler branch off), all draws
    come from ONE vectorized ``standard_normal`` call — bit-equal to the
    scalar stream because ``Generator.normal(0, s)`` is exactly
    ``standard_normal() * s`` and vectorized fills consume the bit stream
    identically to repeated scalar draws; otherwise each step draws through
    the scalar timer at its cursor position, the same calls in the same
    order as the interleaved seed engine.

    steps -- (CS_COMP, rank, sid, sig) | (CS_BLOCK, rank, block, sigs)
             | (CS_IPOST, rank, slot) | (CS_COLL, sid, comm, sig)
             | (CS_P2P, src, dst, sid, sig)
             | (CS_IMATCH, src, dst, sid, slot, sig)
    exec_rows/exec_cols -- the statically-known (rank, sid) pairs executed
             by every sampling step (collectives included), for
             Critter.finish_cold's deferred iter_exec/mean_arr bulk pass
    batch -- lazy cost-model batch support: None until probed, False when
             the timer cannot batch, else (det, sigma) draw-order arrays
    """

    __slots__ = ("steps", "draw_sigs", "n_slots", "max_sid", "exec_rows",
                 "exec_cols", "batch")

    def __init__(self, steps, draw_sigs, n_slots, max_sid, exec_pairs):
        self.steps = steps
        self.draw_sigs = draw_sigs
        self.n_slots = n_slots
        self.max_sid = max_sid
        pairs = sorted(exec_pairs)
        self.exec_rows = np.array([p[0] for p in pairs], dtype=np.intp)
        self.exec_cols = np.array([p[1] for p in pairs], dtype=np.intp)
        self.batch = None


# ------------------------------------------------------------- lowering

def compile_events(events) -> EventProgram:
    """Fuse runs of consecutive comp events of one rank into blocks.

    Only *globally* consecutive runs are fused — the interleaved order
    of interceptions across ranks (and therefore sampler RNG
    consumption) is preserved exactly."""
    out = []
    run_rank = -1
    run: List[int] = []
    n_slots = 0

    def flush():
        nonlocal run
        if len(run) >= MIN_BLOCK:
            out.append((EV_BLOCK, run_rank, CompBlock(run)))
        else:
            out.extend((EV_COMP, run_rank, sid) for sid in run)
        run = []

    for ev in events:
        if ev[0] == EV_COMP:
            if ev[1] != run_rank:
                if run:
                    flush()
                run_rank = ev[1]
            run.append(ev[2])
            continue
        if run:
            flush()
            run_rank = -1
        if ev[0] == EV_IPOST:
            n_slots = ev[3] + 1
        out.append(ev)
    if run:
        flush()
    return EventProgram(out, n_slots)


def build_cold(prog: EventProgram, sigs) -> ColdProgram:
    """Flatten the event program into cold steps plus the forced run's
    static draw sequence (see ColdProgram).  ``sigs`` is the owning
    World's interner table (``world.interner.sigs``)."""
    steps: list = []
    draw_sigs: list = []
    exec_pairs: set = set()
    max_sid = 0
    for ev in prog.events:
        k = ev[0]
        if k == EV_COMP:
            sid = ev[2]
            steps.append((CS_COMP, ev[1], sid, sigs[sid]))
            draw_sigs.append(sigs[sid])
            exec_pairs.add((ev[1], sid))
        elif k == EV_BLOCK:
            block = ev[2]
            bsigs = [sigs[s] for s in block.sids]
            steps.append((CS_BLOCK, ev[1], block, bsigs))
            draw_sigs.extend(bsigs)
            exec_pairs.update((ev[1], s) for s in block.uniq.tolist())
            sid = block.max_sid
        elif k == EV_IPOST:
            sid = ev[2]
            steps.append((CS_IPOST, ev[1], ev[3]))
        elif k == EV_COLL:
            sid = ev[1]
            steps.append((CS_COLL, sid, ev[2], sigs[sid]))
            draw_sigs.append(sigs[sid])
            exec_pairs.update((r, sid) for r in ev[2].ranks)
        elif k == EV_P2P:
            sid = ev[3]
            steps.append((CS_P2P, ev[1], ev[2], sid, sigs[sid]))
            draw_sigs.append(sigs[sid])
            exec_pairs.add((ev[1], sid))
            exec_pairs.add((ev[2], sid))
        else:
            sid = ev[3]
            steps.append((CS_IMATCH, ev[1], ev[2], sid, ev[4],
                          sigs[sid]))
            draw_sigs.append(sigs[sid])
            exec_pairs.add((ev[1], sid))
            exec_pairs.add((ev[2], sid))
        if sid > max_sid:
            max_sid = sid
    return ColdProgram(steps, draw_sigs, prog.n_slots, max_sid,
                       exec_pairs)


def build_warm(prog: EventProgram, sigs) -> WarmProgram:
    """Segment the event program for the compiled selective interpreter.

    Every maximal run of one rank's computation events (plain comps AND
    fused blocks) between two of that rank's *boundaries* — any event
    that touches the rank: a collective it participates in, a p2p it
    sends or receives, an isend post or match — becomes one segment.
    Within a segment no event of any other rank can observe the rank's
    comp-charged state (only boundary events read it), so when every
    kernel in the segment holds a memoized skip verdict the interpreter
    charges the whole segment at the head entry and consumes the member
    entries with a pending counter — the steady-state path that turns
    per-event interpretation into one accumulation loop per segment.
    A guard miss replays the members individually at their original
    positions, so decisions and RNG consumption never reorder."""
    entries: list = []
    # rank -> [entry indices, sids] of its currently-open comp run
    open_runs: Dict[int, list] = {}
    max_sid = 0
    run_sizes: List[int] = []
    n_comp = n_block = n_coll = n_p2p = n_ipost = n_imatch = 0

    def close(r):
        run = open_runs.pop(r, None)
        if run is None:
            return
        idxs, rsids = run
        if len(idxs) < 2:
            return           # single-entry segment: no head needed
        uniq: Dict[int, int] = {}
        for s in rsids:
            uniq[s] = uniq.get(s, 0) + 1
        meta = (rsids, list(uniq), list(uniq.values()), len(rsids),
                len(idxs) - 1)
        head = entries[idxs[0]]
        if head[0] == W_COMP:
            entries[idxs[0]] = (W_CHEAD, head[1], head[2], meta)
        else:
            entries[idxs[0]] = (W_BHEAD, head[1], head[2], head[3],
                                head[4], head[5], meta)
        run_sizes.append(len(rsids))

    for ev in prog.events:
        k = ev[0]
        if k == EV_COMP:
            r = ev[1]
            sid = ev[2]
            if sid > max_sid:
                max_sid = sid
            run = open_runs.get(r)
            if run is None:
                run = open_runs[r] = [[], []]
            run[0].append(len(entries))
            run[1].append(sid)
            entries.append((W_COMP, r, sid))
            n_comp += 1
        elif k == EV_BLOCK:
            r = ev[1]
            block = ev[2]
            if block.max_sid > max_sid:
                max_sid = block.max_sid
            run = open_runs.get(r)
            if run is None:
                run = open_runs[r] = [[], []]
            run[0].append(len(entries))
            run[1].extend(block.sids)
            entries.append((W_BLOCK, r, block.sids, block.uniq.tolist(),
                            block.counts.tolist(), block.n))
            n_block += 1
        elif k == EV_IPOST:
            r = ev[1]
            sid = ev[2]
            if sid > max_sid:
                max_sid = sid
            close(r)
            entries.append((W_IPOST, r, sid, ev[3]))
            n_ipost += 1
        elif k == EV_COLL:
            sid = ev[1]
            comm = ev[2]
            if sid > max_sid:
                max_sid = sid
            for r in comm.ranks:
                close(r)
            entries.append((W_COLL, sid, comm, comm.ranks, sigs[sid]))
            n_coll += 1
        elif k == EV_P2P:
            sid = ev[3]
            if sid > max_sid:
                max_sid = sid
            close(ev[1])
            close(ev[2])
            entries.append((W_P2P, ev[1], ev[2], sid, sigs[sid]))
            n_p2p += 1
        else:                               # EV_IMATCH
            sid = ev[3]
            if sid > max_sid:
                max_sid = sid
            close(ev[1])
            close(ev[2])
            entries.append((W_IMATCH, ev[1], ev[2], sid, ev[4],
                            sigs[sid]))
            n_imatch += 1
    for r in list(open_runs):
        close(r)

    fused = sum(run_sizes)
    meta = {
        "entries": len(entries),
        "segments": len(run_sizes),
        "fused_events": fused,
        "max_batch": max(run_sizes) if run_sizes else 0,
        "mean_batch": round(fused / len(run_sizes), 2)
        if run_sizes else 0.0,
        "comp_entries": n_comp,
        "block_entries": n_block,
        "coll_entries": n_coll,
        "p2p_entries": n_p2p,
        "ipost_entries": n_ipost,
        "imatch_entries": n_imatch,
    }
    return WarmProgram(entries, prog.n_slots, max_sid, meta)


# --------------------------------------------------------- serialization

class ProgramCacheError(ValueError):
    """A cache artifact failed validation (version, fingerprint, checksum,
    or structure).  Raised by the payload codec; the cache itself converts
    it into a loud re-record."""


def _canon(value) -> str:
    """Canonical JSON for fingerprint material: sorted keys, tuples as
    lists, compact separators — deterministic across processes."""
    def default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        raise TypeError(f"unfingerprintable value {o!r}")
    return json.dumps(value, sort_keys=True, separators=(",", ":"),
                      default=default)


def structural_fingerprint(space_name: str, point_name: str, params: dict,
                           world_size: int) -> str:
    """The program's content address: crc32 over the canonical JSON of
    (study key, point name, geometry params, world size, format version).

    The caller's contract is that these determine the recorded structure —
    true for every study space in this repo, whose point params carry the
    full geometry.  Two spaces that reuse a name/params pair for different
    program factories must not share a cache."""
    material = {"space": space_name, "point": point_name,
                "params": params, "world": world_size,
                "version": PROGRAM_VERSION}
    return "prog%d:%08x" % (PROGRAM_VERSION,
                            zlib.crc32(_canon(material).encode()))


def _tupled(x):
    """JSON list -> tuple, recursively (signature params round-trip)."""
    if isinstance(x, list):
        return tuple(_tupled(v) for v in x)
    return x


def program_to_payload(prog: EventProgram, sigs,
                       comms: Optional[List] = None) -> dict:
    """Serialize a compiled event program into a JSON-able payload.

    ``sigs`` is the recording World's interner table; the payload stores
    only the signatures this program references, ordered by their
    record-time sid (the loader re-interns them in that order — see the
    module docstring's bit-identity contract).  ``comms`` is the ordered
    list of communicator rank-tuples the recording pass *created* (the
    ``World._comms`` delta), replayed on load so the channel registry
    evolves identically."""
    ref: set = set()
    for ev in prog.events:
        k = ev[0]
        if k == EV_COMP:
            ref.add(ev[2])
        elif k == EV_BLOCK:
            ref.update(ev[2].sids)
        elif k == EV_COLL:
            ref.add(ev[1])
        elif k == EV_IPOST:
            ref.add(ev[2])
        else:                       # EV_P2P, EV_IMATCH
            ref.add(ev[3])
    order = sorted(ref)
    local = {sid: i for i, sid in enumerate(order)}
    table = [[sigs[sid].kind, sigs[sid].name, list(sigs[sid].params)]
             for sid in order]
    events = []
    for ev in prog.events:
        k = ev[0]
        if k == EV_COMP:
            events.append([k, ev[1], local[ev[2]]])
        elif k == EV_BLOCK:
            events.append([k, ev[1], [local[s] for s in ev[2].sids]])
        elif k == EV_COLL:
            events.append([k, local[ev[1]], list(ev[2].ranks)])
        elif k == EV_P2P:
            events.append([k, ev[1], ev[2], local[ev[3]]])
        elif k == EV_IPOST:
            events.append([k, ev[1], local[ev[2]], ev[3]])
        else:                       # EV_IMATCH
            events.append([k, ev[1], ev[2], local[ev[3]], ev[4]])
    return {"version": PROGRAM_VERSION, "n_slots": prog.n_slots,
            "sigs": table,
            "comms": [list(c) for c in (comms or [])],
            "events": events}


def program_from_payload(payload: dict, world) -> EventProgram:
    """Materialize an ``EventProgram`` from a payload into ``world``.

    Replays the recorded communicator creations (in order), re-interns the
    signature table (in record-sid order), and rebuilds the compiled event
    tuples — ``CompBlock``s from their sid lists, collectives bound to
    ``world.comm(ranks)``.  Raises ``ProgramCacheError`` on any structural
    problem; never partially mutates engine statistics (interning and comm
    creation are idempotent and profile-free)."""
    try:
        if payload["version"] != PROGRAM_VERSION:
            raise ProgramCacheError(
                f"program artifact version {payload['version']!r} != "
                f"supported {PROGRAM_VERSION}")
        for ranks in payload["comms"]:
            world.comm(ranks)
        intern = world.interner.intern
        sid_map = [intern(Signature(kind, name, _tupled(params)))
                   for kind, name, params in payload["sigs"]]
        events: list = []
        append = events.append
        for ev in payload["events"]:
            k = ev[0]
            if k == EV_COMP:
                append((EV_COMP, ev[1], sid_map[ev[2]]))
            elif k == EV_BLOCK:
                append((EV_BLOCK, ev[1],
                        CompBlock([sid_map[s] for s in ev[2]])))
            elif k == EV_COLL:
                append((EV_COLL, sid_map[ev[1]], world.comm(ev[2])))
            elif k == EV_P2P:
                append((EV_P2P, ev[1], ev[2], sid_map[ev[3]]))
            elif k == EV_IPOST:
                append((EV_IPOST, ev[1], sid_map[ev[2]], ev[3]))
            elif k == EV_IMATCH:
                append((EV_IMATCH, ev[1], ev[2], sid_map[ev[3]], ev[4]))
            else:
                raise ProgramCacheError(f"unknown event opcode {k!r}")
        return EventProgram(events, payload["n_slots"])
    except ProgramCacheError:
        raise
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise ProgramCacheError(
            f"malformed program payload: {type(e).__name__}: {e}") from e


# ---------------------------------------------------------------- cache

class ProgramCache:
    """Content-addressed cache of recorded event programs.

    In-process LRU over serialized payloads (world-independent, so one
    cache serves many Worlds/Runtimes), optionally backed by a directory
    of crash-atomically written, crc32-validated JSON artifacts — the
    sweep-scoped store remote workers keep across tasks and the on-disk
    store that survives processes.  Every disk read validates version,
    fingerprint, and payload checksum; any mismatch is reported LOUDLY on
    stderr (and counted in ``rejects``) and treated as a miss, so a stale
    or torn artifact triggers a re-record, never a silent replay.

    Not thread-safe for concurrent mutation within one process (the engine
    is single-threaded per Runtime); concurrent *processes* sharing one
    cache directory are safe — writes go through mkstemp + fsync +
    ``os.replace``, so readers see either the old artifact or the new one,
    never a torn file."""

    def __init__(self, path: Optional[str] = None, capacity: int = 64):
        self.path = path
        self.capacity = capacity
        self._mem: "OrderedDict[str, dict]" = OrderedDict()
        self.hits = 0          # get() calls satisfied (mem or disk)
        self.misses = 0        # get() calls that found nothing valid
        self.disk_hits = 0     # hits that came off disk
        self.stores = 0        # put() calls
        self.rejects = 0       # invalid artifacts refused (loud fallback)
        self.last_reject: Optional[str] = None

    def __len__(self) -> int:
        return len(self._mem)

    # -- internals ---------------------------------------------------------

    def _file(self, fingerprint: str) -> str:
        return os.path.join(self.path, fingerprint.replace(":", "_")
                            + ".json")

    def _reject(self, reason: str) -> None:
        self.rejects += 1
        self.last_reject = reason
        print(f"program cache: {reason}; falling back to re-recording",
              file=sys.stderr, flush=True)

    def _insert(self, fingerprint: str, payload: dict) -> None:
        self._mem[fingerprint] = payload
        self._mem.move_to_end(fingerprint)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)

    def _load_disk(self, fingerprint: str) -> Optional[dict]:
        f = self._file(fingerprint)
        try:
            with open(f) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            self._reject(f"unreadable artifact {f}: {e}")
            return None
        if not isinstance(doc, dict) or "payload" not in doc:
            self._reject(f"artifact {f} is not a program document")
            return None
        if doc.get("version") != PROGRAM_VERSION:
            self._reject(f"artifact {f} has version {doc.get('version')!r}"
                         f" != supported {PROGRAM_VERSION}")
            return None
        if doc.get("fingerprint") != fingerprint:
            self._reject(f"artifact {f} carries fingerprint "
                         f"{doc.get('fingerprint')!r}, expected "
                         f"{fingerprint!r}")
            return None
        payload = doc["payload"]
        crc = zlib.crc32(_canon(payload).encode())
        if doc.get("crc32") != crc:
            self._reject(f"artifact {f} failed checksum validation "
                         f"(stored {doc.get('crc32')!r}, computed {crc})")
            return None
        return payload

    def _store_disk(self, fingerprint: str, payload: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        doc = {"version": PROGRAM_VERSION, "fingerprint": fingerprint,
               "crc32": zlib.crc32(_canon(payload).encode()),
               "payload": payload}
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self._file(fingerprint)) + ".",
            suffix=".tmp", dir=self.path)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._file(fingerprint))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- public API --------------------------------------------------------

    def lookup(self, fingerprint: str) -> Optional[dict]:
        """The raw payload for ``fingerprint`` (LRU, then disk), or
        ``None``.  Does not touch hit/miss counters."""
        payload = self._mem.get(fingerprint)
        if payload is not None:
            self._mem.move_to_end(fingerprint)
            return payload
        if self.path:
            payload = self._load_disk(fingerprint)
            if payload is not None:
                self.disk_hits += 1
                self._insert(fingerprint, payload)
                return payload
        return None

    def get(self, fingerprint: str, world) -> Optional[EventProgram]:
        """Materialize the cached program for ``fingerprint`` into
        ``world``, or ``None`` on a miss.  A payload that fails
        materialization is rejected loudly and treated as a miss."""
        payload = self.lookup(fingerprint)
        if payload is not None:
            try:
                prog = program_from_payload(payload, world)
            except ProgramCacheError as e:
                self._mem.pop(fingerprint, None)
                self._reject(str(e))
            else:
                self.hits += 1
                return prog
        self.misses += 1
        return None

    def put(self, fingerprint: str, prog: EventProgram, world,
            comms: Optional[List] = None) -> dict:
        """Serialize ``prog`` (recorded in ``world``) under
        ``fingerprint``, into the LRU and — when a directory is configured
        — crash-atomically onto disk.  Returns the payload."""
        payload = program_to_payload(prog, world.interner.sigs, comms)
        self._insert(fingerprint, payload)
        self.stores += 1
        if self.path:
            self._store_disk(fingerprint, payload)
        return payload

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "disk_hits": self.disk_hits, "stores": self.stores,
                "rejects": self.rejects, "entries": len(self._mem)}
