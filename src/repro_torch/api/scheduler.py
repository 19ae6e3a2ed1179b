"""Async work-queue scheduling of sweep tasks over pluggable executors.

The sweep machinery used to be scattered across ``session.sweep`` (grid
logic + checkpoint), ``parallel.run_tasks`` (a fork pool), and the
benchmark drivers.  This module lifts it into one subsystem:

- a ``Task`` is one unit of sweep work (one (policy, tolerance, seed,
  allocation) study) with explicit state — ``pending`` -> ``running`` ->
  ``done`` | ``failed`` — and an attempt history (``attempts``: one entry
  per failed execution, with the error and the worker it ran on);
- an ``Executor`` is the substrate tasks run on:

  * ``InProcessExecutor`` — synchronous, in this process (the serial
    driver; the only executor for backends that are not ``parallel_safe``);
  * ``ForkExecutor``      — ``os.fork`` children, results over pipes
    (subsumes the old ``repro.api.parallel`` pool: study spaces carry
    closures that do not pickle, and a forked child inherits them — plus
    the parent's warm imports — for free);
  * ``RemoteExecutor``    — socket-connected ``python -m repro.api.worker``
    processes speaking newline-delimited JSON; each worker owns its own
    (space, backend) built from an import spec and executes the same task
    payloads, so a sweep can span machines;

- the ``Scheduler`` drives the queue asynchronously: it keeps the executor
  saturated up to its capacity, builds each task's payload at *dispatch*
  time (``prepare`` hook — this is what lets mid-sweep statistics sharing
  hand later tasks the priors harvested from earlier completions, see
  ``session.AutotuneSession.sweep(share_stats=True)``), and fires
  ``on_done`` as results land, in completion order.

Tasks are dispatched in queue order and the caller merges results by task
index, so the *merged* output is deterministic regardless of completion
order; whether the measurements themselves are scheduling-independent is
the caller's contract (cold tasks always are; mid-sweep sharing is not,
which is why the session offers ``deterministic=True``).

Failure semantics — at fleet scale worker loss and stragglers are
routine, so a task error does not abort the sweep by default policy
alone:

- a failed execution (worker death, task deadline, task exception) is
  recorded in ``Task.attempts`` and the task is *requeued* with
  exponential backoff, up to ``max_retries`` extra attempts; a retried
  task's payload is rebuilt by ``prepare`` at re-dispatch;
- only when retries are exhausted does the task reach ``failed``; then
  ``on_failure="raise"`` (default) raises ``SchedulerError`` carrying the
  full attempt history, while ``on_failure="skip"`` records the failure
  and lets the rest of the grid complete (partial results);
- every recovery event (retry, task failure, worker loss/join, heartbeat
  timeout, task deadline) flows through the ``on_event`` callback so
  callers can journal it (``session.sweep`` persists them into the sweep
  checkpoint and surfaces per-task histories in ``StudyResult.extra``);
- ``RemoteExecutor`` detects *wedged* (not just disconnected) workers via
  a per-task deadline (``task_timeout``) and idle-worker liveness pings
  (``heartbeat_interval`` + the worker protocol's ``{"op": "ping"}``),
  and can accept workers joining mid-sweep on a listening socket
  (``listen=``; workers dial in with ``--connect``), so capacity
  recovers — see ``repro.api.supervisor.WorkerPool`` for the process
  supervision half.

Interrupts stay interrupts: executors convert task ``Exception``s into
failed attempts but let ``KeyboardInterrupt``/``SystemExit`` propagate
(the scheduler still closes the executor on the way out).
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import sys
import time
import traceback
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"

#: exhausted-retries policies (see ``Scheduler``)
ON_FAILURE = ("raise", "skip")


class SchedulerError(RuntimeError):
    """A task failed on its executor (the attempt history and the last
    worker traceback are in the message; the failed ``Task`` is in
    ``.task``)."""

    def __init__(self, message: str, task: "Task" = None):
        super().__init__(message)
        self.task = task


@dataclass
class Task:
    """One unit of sweep work, with explicit lifecycle state."""

    index: int                     # position in the submission order
    spec: Any                      # caller-level description (opaque here)
    state: str = PENDING
    payload: Optional[dict] = None  # JSON-able message built at dispatch
    result: Optional[dict] = None   # the runner's JSON result (state DONE)
    error: Optional[str] = None     # last traceback (state FAILED)
    #: one entry per *failed* execution: {"attempt": n, "error": traceback,
    #: "worker": identity} — a task that eventually succeeded keeps its
    #: earlier failures here (surfaced as recovery provenance)
    attempts: List[dict] = field(default_factory=list)
    meta: dict = field(default_factory=dict)


def fork_available() -> bool:
    return hasattr(os, "fork")


def _last_line(tb: Optional[str]) -> str:
    if not tb:
        return "?"
    lines = [ln for ln in tb.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else "?"


# ------------------------------------------------------------- executors

class Executor:
    """Task execution substrate.

    ``start(runner)`` readies the executor (``runner(payload) -> dict`` is
    the in-process task function; socket executors ignore it and ship the
    payload instead).  ``submit`` must not block on task completion;
    ``poll`` blocks until at least one in-flight task finishes and returns
    ``[(task_index, {"ok": result} | {"err": traceback, "worker": id})]``.
    ``capacity`` is the number of tasks the executor can hold in flight;
    ``can_grow`` executors may regain capacity while the scheduler waits
    (elastic worker join), so losing every worker is not final until a
    join window expires.  Recovery events accumulate via ``_emit`` and are
    drained by the scheduler through ``drain_events``.
    """

    capacity: int = 1
    can_grow: bool = False

    def start(self, runner: Callable[[dict], dict]) -> None:
        raise NotImplementedError

    def submit(self, index: int, payload: dict) -> None:
        raise NotImplementedError

    def poll(self) -> List[Tuple[int, dict]]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def _emit(self, **event) -> None:
        self.__dict__.setdefault("_events", []).append(event)

    def drain_events(self) -> List[dict]:
        """Recovery events (worker loss/join/restart, timeouts) since the
        last drain, oldest first."""
        ev = self.__dict__.get("_events")
        if not ev:
            return []
        out, ev[:] = list(ev), []
        return out


class InProcessExecutor(Executor):
    """Synchronous execution in the calling process — the serial driver.

    ``submit`` runs the task immediately (capacity 1 keeps the scheduler
    from queueing ahead), so execution order is exactly submission order
    and shared in-process state (e.g. a study checkpoint journaling
    per-configuration records) behaves as under the historical serial
    sweep."""

    capacity = 1

    def __init__(self):
        self._runner = None
        self._ready: List[Tuple[int, dict]] = []

    def start(self, runner) -> None:
        self._runner = runner

    def submit(self, index: int, payload: dict) -> None:
        # Exception, not BaseException: Ctrl-C / SystemExit must interrupt
        # the sweep, not masquerade as a failed (and then retried!) task
        try:
            out = {"ok": self._runner(payload)}
        except Exception:
            out = {"err": traceback.format_exc(), "worker": "in-process"}
        self._ready.append((index, out))

    def poll(self) -> List[Tuple[int, dict]]:
        out, self._ready = self._ready, []
        return out


class ForkExecutor(Executor):
    """``os.fork`` children, one per in-flight task, results over pipes.

    Children return results as JSON over a pipe (length-unframed: the
    child writes once and closes; the parent reads to EOF via
    ``selectors`` so pipe-buffer backpressure cannot deadlock the pool).
    """

    def __init__(self, workers: int):
        if not fork_available():
            raise RuntimeError("ForkExecutor requires os.fork")
        self.capacity = max(int(workers), 1)
        self._runner = None
        self._sel = None
        self._live: Dict[int, dict] = {}       # read-fd -> {index, pid, buf}

    def start(self, runner) -> None:
        self._runner = runner
        self._sel = selectors.DefaultSelector()

    def submit(self, index: int, payload: dict) -> None:
        rfd, wfd = os.pipe()
        # jax warns on any fork once imported anywhere in the process;
        # backends that actually touch jax declare parallel_safe=False and
        # never reach this pool, so the warning is noise here
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message=r".*os\.fork\(\).*",
                category=RuntimeWarning)
            pid = os.fork()
        if pid == 0:                            # child
            os.close(rfd)
            code = 0
            try:
                out = {"ok": self._runner(payload)}
            except BaseException:               # the child must report and
                out = {"err": traceback.format_exc()}   # die, whatever hit it
                code = 1
            try:
                with os.fdopen(wfd, "w") as w:
                    json.dump(out, w)
                sys.stdout.flush()
                sys.stderr.flush()
            finally:
                os._exit(code)                  # skip parent atexit/finalizers
        os.close(wfd)
        os.set_blocking(rfd, False)
        self._live[rfd] = {"index": index, "pid": pid, "buf": bytearray()}
        self._sel.register(rfd, selectors.EVENT_READ)

    def poll(self) -> List[Tuple[int, dict]]:
        results: List[Tuple[int, dict]] = []
        while not results and self._live:
            for key, _ in self._sel.select():
                rfd = key.fd
                st = self._live[rfd]
                while True:
                    try:
                        chunk = os.read(rfd, 1 << 16)
                    except BlockingIOError:
                        break
                    if not chunk:               # EOF: child wrote and closed
                        self._sel.unregister(rfd)
                        os.close(rfd)
                        del self._live[rfd]
                        os.waitpid(st["pid"], 0)
                        raw = bytes(st["buf"])
                        if not raw:
                            self._emit(event="worker_lost",
                                       worker=f"fork:{st['pid']}",
                                       task=st["index"])
                            out = {"err": f"fork worker for task "
                                          f"{st['index']} died without a "
                                          f"result",
                                   "worker": f"fork:{st['pid']}"}
                        else:
                            out = json.loads(raw)
                            if "err" in out:
                                out.setdefault("worker",
                                               f"fork:{st['pid']}")
                        results.append((st["index"], out))
                        break
                    st["buf"] += chunk
        return results

    def close(self) -> None:
        for st in self._live.values():
            try:
                os.kill(st["pid"], 9)
                os.waitpid(st["pid"], 0)
            except OSError:
                pass
        self._live.clear()


class RemoteExecutor(Executor):
    """Socket-connected remote workers (``python -m repro.api.worker``).

    ``addresses`` are ``"host:port"`` strings; one task is in flight per
    worker.  The protocol is newline-delimited JSON:

    - ``{"op": "hello"}`` -> ``{"ok": {"space", "n_points", "backend"}}``
      (sent at ``start`` and to every joining worker; when the scheduler
      supplies ``expect``, the worker's space/backend identity is checked
      against it so a sweep never lands on a worker tuning a different
      study);
    - ``{"op": "run", "id": i, "task": payload}`` -> ``{"id": i,
      "ok": result}`` or ``{"id": i, "err": traceback}``;
    - ``{"op": "ping"}`` -> ``{"ok": "pong"}`` (liveness heartbeat).

    Workers own their (space, backend) — closures never cross the wire,
    only task payloads and JSON results, which is what lets a sweep span
    machines.  Recorded event programs never cross it either: payloads
    carry per-point *structural fingerprints* (``program_fingerprints``,
    attached by ``AutotuneSession._task_payload`` when the dispatching
    backend has a ``ProgramCache``), and each worker keeps its own
    sweep-scoped cache (``--program-cache``, default in-memory), so a
    worker records each unique geometry once across every task it serves
    and re-dispatch never re-ships — or re-records — a program the worker
    already holds.  Fingerprint mismatch between dispatcher and worker is
    a loud task error (geometry drift), surfaced like any task failure.

    Fault tolerance:

    - a worker that disconnects mid-task yields an ``err`` result (the
      scheduler requeues the task) and stops counting toward capacity;
    - ``task_timeout`` is a per-task deadline: a *wedged* worker — alive
      but silent past the deadline — is dropped and its task reassigned
      (without it, a hung worker stalls ``poll`` forever);
    - ``heartbeat_interval`` pings idle workers; one that stays silent for
      a further interval is dropped before a task is wasted on it (busy
      workers are covered by the task deadline — a single-threaded worker
      cannot answer pings mid-task);
    - ``listen`` (``"host:port"`` or an int port; 0 binds an ephemeral
      port, see ``listen_address``) accepts workers joining mid-sweep:
      ``python -m repro.api.worker --connect <listen_address>`` dials in,
      is identity-checked like a static worker, and restores capacity —
      this is how a supervisor-restarted worker rejoins
      (``repro.api.supervisor.WorkerPool``).  With only elastic workers
      (``addresses=()``), ``poll`` waits up to ``join_timeout`` for the
      first join before the scheduler declares the fleet lost."""

    def __init__(self, addresses: Sequence[str] = (), *,
                 expect: Optional[dict] = None, timeout: float = 30.0,
                 task_timeout: Optional[float] = None,
                 heartbeat_interval: Optional[float] = None,
                 listen: Union[str, int, None] = None,
                 join_timeout: float = 30.0):
        self.addresses = list(addresses)
        self._srv = None
        self.listen_address: Optional[str] = None
        if listen is not None:
            spec = listen if isinstance(listen, str) else f":{int(listen)}"
            host, port = self._parse(spec)
            self._srv = socket.create_server((host, port))
            self._srv.setblocking(False)
            bh, bp = self._srv.getsockname()[:2]
            self.listen_address = f"{bh}:{bp}"
        if not self.addresses and self._srv is None:
            raise ValueError("RemoteExecutor needs at least one worker "
                             "address (or listen= for elastic workers)")
        self.capacity = len(self.addresses)
        self.expect = expect
        self.timeout = timeout
        self.task_timeout = task_timeout
        self.heartbeat_interval = heartbeat_interval
        self.join_timeout = join_timeout
        self._sel = None
        self._workers: Dict[socket.socket, dict] = {}
        self._free: List[socket.socket] = []
        self._stash: List[Tuple[int, dict]] = []

    @property
    def can_grow(self) -> bool:
        return self._srv is not None

    @staticmethod
    def _parse(addr: str) -> Tuple[str, int]:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    @staticmethod
    def _send(sock: socket.socket, msg: dict) -> None:
        sock.sendall(json.dumps(msg).encode() + b"\n")

    @staticmethod
    def _recv_line(sock: socket.socket, buf: bytearray) -> dict:
        """Blocking read of one JSON line (handshakes only; task replies
        go through the selector loop in ``poll``)."""
        while b"\n" not in buf:
            chunk = sock.recv(1 << 16)
            if not chunk:
                raise SchedulerError("remote worker closed the connection "
                                     "during handshake")
            buf += chunk
        line, _, rest = bytes(buf).partition(b"\n")
        buf[:] = rest
        return json.loads(line)

    def start(self, runner) -> None:          # runner unused: work ships out
        self._sel = selectors.DefaultSelector()
        if self._srv is not None:
            self._sel.register(self._srv, selectors.EVENT_READ)
        for addr in self.addresses:
            host, port = self._parse(addr)
            sock = socket.create_connection((host, port),
                                            timeout=self.timeout)
            self._admit(sock, addr)

    def _admit(self, sock: socket.socket, addr: str) -> None:
        """Handshake a worker (static or joining) and add it to the pool;
        raises ``SchedulerError`` on identity mismatch."""
        sock.settimeout(self.timeout)
        buf = bytearray()
        self._send(sock, {"op": "hello"})
        hello = self._recv_line(sock, buf)
        if "err" in hello:
            raise SchedulerError(
                f"worker {addr} refused hello: {hello['err']}")
        ident = hello.get("ok", {})
        if self.expect is not None:
            for k, want in self.expect.items():
                got = ident.get(k)
                if got != want:
                    raise SchedulerError(
                        f"worker {addr} serves {k}={got!r}, this sweep "
                        f"needs {k}={want!r} — wrong --spec?")
        sock.setblocking(False)
        now = time.monotonic()
        self._workers[sock] = {"addr": addr, "buf": buf, "ident": ident,
                               "index": None, "t_dispatch": None,
                               "last_seen": now, "ping_sent": None}
        self._free.append(sock)
        self._sel.register(sock, selectors.EVENT_READ)
        self.capacity = len(self._workers)

    def _accept(self) -> None:
        """An elastic worker dialed the listening socket: handshake it
        like a static one; a mismatched or broken joiner is rejected
        without disturbing the sweep."""
        try:
            conn, peer = self._srv.accept()
        except OSError:
            return
        addr = f"{peer[0]}:{peer[1]}"
        try:
            self._admit(conn, addr)
        except (SchedulerError, OSError, ValueError) as e:
            self._emit(event="worker_rejected", worker=addr,
                       error=str(e))
            try:
                conn.close()
            except OSError:
                pass
            return
        self._emit(event="worker_joined", worker=addr,
                   capacity=self.capacity)

    def submit(self, index: int, payload: dict) -> None:
        while self._free:
            sock = self._free.pop(0)
            st = self._workers[sock]
            try:
                sock.settimeout(self.timeout)   # a wedged worker fails the
                self._send(sock, {"op": "run", "id": index,    # send
                                  "task": payload})
                sock.setblocking(False)
            except OSError:
                # the worker died while idle: try the next free one
                self._emit(event="worker_lost", worker=st["addr"],
                           phase="submit")
                self._drop(sock)
                continue
            st["index"] = index
            st["t_dispatch"] = time.monotonic()
            return
        # every free worker turned out dead at dispatch: fail the attempt
        # (the scheduler retries or raises per its policy)
        self._stash.append((index, {
            "err": f"no live remote worker available for task {index}",
            "worker": None}))

    def poll(self) -> List[Tuple[int, dict]]:
        results, self._stash = self._stash, []
        join_deadline = time.monotonic() + self.join_timeout
        while not results:
            busy = any(st["index"] is not None
                       for st in self._workers.values())
            if not busy:
                # nothing in flight: hand control back so the scheduler
                # can dispatch — unless the pool is empty and elastic, in
                # which case wait (up to join_timeout) for a worker to join
                if self._free or not self.can_grow:
                    break
                if time.monotonic() >= join_deadline:
                    break
            for key, _ in self._sel.select(
                    self._tick(busy, join_deadline)):
                if key.fileobj is self._srv:
                    self._accept()
                    continue
                self._read(key.fileobj, results)
            now = time.monotonic()
            self._check_deadlines(now, results)
            self._check_heartbeats(now)
        return results

    def _tick(self, busy: bool, join_deadline: float) -> Optional[float]:
        """The next time-driven wakeup: task deadline, heartbeat due, or
        join-window expiry.  None = block until socket activity."""
        now = time.monotonic()
        cands: List[float] = []
        if not busy and self.can_grow and not self._free:
            cands.append(join_deadline - now)
        if self.task_timeout is not None:
            for st in self._workers.values():
                if st["t_dispatch"] is not None:
                    cands.append(st["t_dispatch"] + self.task_timeout - now)
        if self.heartbeat_interval is not None:
            for st in self._workers.values():
                if st["index"] is None:
                    base = st["ping_sent"] if st["ping_sent"] is not None \
                        else st["last_seen"]
                    cands.append(base + self.heartbeat_interval - now)
        if not cands:
            return None
        return max(0.0, min(cands))

    def _read(self, sock: socket.socket,
              results: List[Tuple[int, dict]]) -> None:
        st = self._workers.get(sock)
        if st is None:
            return
        try:
            chunk = sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            chunk = b""
        if not chunk:
            idx = st["index"]
            self._emit(event="worker_lost", worker=st["addr"], task=idx,
                       phase="recv")
            self._drop(sock)
            if idx is not None:
                results.append((idx, {
                    "err": f"remote worker {st['addr']} died mid-task",
                    "worker": st["addr"]}))
            return
        st["buf"] += chunk
        st["last_seen"] = time.monotonic()
        while b"\n" in st["buf"]:
            line, _, rest = bytes(st["buf"]).partition(b"\n")
            st["buf"][:] = rest
            try:
                msg = json.loads(line)
            except ValueError:
                # a corrupt reply means the stream cannot be trusted:
                # fail the in-flight task and drop the worker
                idx = st["index"]
                self._emit(event="worker_lost", worker=st["addr"],
                           task=idx, phase="corrupt-reply")
                self._drop(sock)
                if idx is not None:
                    results.append((idx, {
                        "err": f"remote worker {st['addr']} sent a "
                               f"corrupt reply: {line[:120]!r}",
                        "worker": st["addr"]}))
                return
            if msg.get("ok") == "pong" and "id" not in msg:
                st["ping_sent"] = None          # heartbeat answered
                continue
            idx = msg.get("id", st["index"])
            st["index"] = None
            st["t_dispatch"] = None
            self._free.append(sock)
            out = {"ok": msg["ok"]} if "ok" in msg \
                else {"err": msg.get("err", "malformed reply"),
                      "worker": st["addr"]}
            results.append((idx, out))

    def _check_deadlines(self, now: float,
                         results: List[Tuple[int, dict]]) -> None:
        """Drop busy workers whose task has exceeded ``task_timeout`` —
        a wedged worker never closes its socket, so only a deadline can
        unstick the sweep."""
        if self.task_timeout is None:
            return
        for sock, st in list(self._workers.items()):
            if st["t_dispatch"] is None:
                continue
            if now - st["t_dispatch"] >= self.task_timeout:
                idx = st["index"]
                self._emit(event="task_deadline", worker=st["addr"],
                           task=idx, timeout_s=self.task_timeout)
                self._drop(sock)
                results.append((idx, {
                    "err": f"remote worker {st['addr']} exceeded the "
                           f"{self.task_timeout}s task deadline on task "
                           f"{idx} (wedged?) — dropped for reassignment",
                    "worker": st["addr"]}))

    def _check_heartbeats(self, now: float) -> None:
        """Ping idle workers every ``heartbeat_interval``; one whose ping
        stays unanswered for a further interval is dropped."""
        if self.heartbeat_interval is None:
            return
        for sock, st in list(self._workers.items()):
            if st["index"] is not None:
                continue        # busy workers are the task deadline's job
            if st["ping_sent"] is not None:
                if now - st["ping_sent"] >= self.heartbeat_interval:
                    self._emit(event="heartbeat_timeout",
                               worker=st["addr"],
                               silent_s=round(now - st["last_seen"], 3))
                    self._drop(sock)
                continue
            if now - st["last_seen"] >= self.heartbeat_interval:
                try:
                    self._send(sock, {"op": "ping"})
                    st["ping_sent"] = now
                except BlockingIOError:
                    pass                        # send buffer full: later
                except OSError:
                    self._emit(event="worker_lost", worker=st["addr"],
                               phase="ping")
                    self._drop(sock)

    def _drop(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        self._workers.pop(sock, None)
        if sock in self._free:
            self._free.remove(sock)
        # a dead worker no longer counts toward in-flight capacity; with a
        # listening socket the capacity can recover as workers rejoin,
        # otherwise the scheduler raises once none remains
        self.capacity = len(self._workers)
        sock.close()

    def close(self) -> None:
        for sock in list(self._workers):
            try:
                sock.close()
            except OSError:
                pass
        self._workers.clear()
        self._free.clear()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass


# ------------------------------------------------------------- scheduler

class Scheduler:
    """Drives a task queue over an executor, keeping it saturated.

    ``run(specs, prepare=..., on_done=...)`` turns each spec into a
    ``Task``, builds its payload at dispatch time via ``prepare(task)``
    (late binding — this is the mid-sweep statistics-sharing hook), and
    executes them ``executor.capacity`` at a time.  ``on_done(task)``
    fires as each task completes, in completion order.  Returns the full
    task list (submission order) once every task reached a terminal state.

    Failure policy: a failed execution is requeued (payload rebuilt by
    ``prepare``) with exponential backoff ``retry_backoff * 2**(n-1)``,
    up to ``max_retries`` extra attempts; each failure is recorded in
    ``Task.attempts``.  Once exhausted, ``on_failure="raise"`` raises
    ``SchedulerError`` with the full history, ``"skip"`` marks the task
    ``failed`` and completes the rest of the queue.  ``on_event(dict)``
    receives every recovery event (``task_retry``, ``task_failed``, plus
    whatever the executor emits: ``worker_lost``, ``worker_joined``,
    ``task_deadline``, ``heartbeat_timeout``...)."""

    def __init__(self, executor: Executor,
                 runner: Optional[Callable[[dict], dict]] = None, *,
                 max_retries: int = 0, retry_backoff: float = 0.0,
                 on_failure: str = "raise",
                 on_event: Optional[Callable[[dict], None]] = None):
        if on_failure not in ON_FAILURE:
            raise ValueError(f"on_failure must be one of {ON_FAILURE}, "
                             f"got {on_failure!r}")
        self.executor = executor
        self.runner = runner
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.on_failure = on_failure
        self.on_event = on_event

    def _emit(self, event: dict) -> None:
        if self.on_event is not None:
            self.on_event(event)

    def _drain(self) -> None:
        for ev in self.executor.drain_events():
            self._emit(ev)

    def run(self, specs: Sequence[Any], *,
            prepare: Optional[Callable[[Task], dict]] = None,
            on_done: Optional[Callable[[Task], None]] = None) -> List[Task]:
        tasks = [Task(i, spec) for i, spec in enumerate(specs)]
        ex = self.executor
        queue = deque(tasks)
        waiting: List[Tuple[float, Task]] = []   # (ready_at, task) backoffs
        inflight: Dict[int, Task] = {}
        try:
            ex.start(self.runner)
            self._drain()
            while queue or waiting or inflight:
                if waiting:
                    now = time.monotonic()
                    due = [t for ready, t in waiting if ready <= now]
                    waiting = [(r, t) for r, t in waiting if r > now]
                    queue.extend(due)
                while queue and len(inflight) < ex.capacity:
                    t = queue.popleft()
                    t.payload = prepare(t) if prepare is not None \
                        else t.spec
                    t.state = RUNNING
                    inflight[t.index] = t
                    ex.submit(t.index, t.payload)
                if not inflight:
                    if waiting:
                        time.sleep(max(0.0, min(r for r, _ in waiting)
                                       - time.monotonic()))
                        continue
                    if queue:
                        # an elastic executor may regain capacity (worker
                        # restart + rejoin); give it one join window
                        if ex.can_grow:
                            ex.poll()
                            self._drain()
                            if ex.capacity > 0:
                                continue
                        raise SchedulerError(
                            f"executor has no capacity left with "
                            f"{len(queue)} tasks still pending (all "
                            f"workers lost?)")
                    break
                for idx, out in ex.poll():
                    t = inflight.pop(idx, None)
                    if t is None:
                        continue        # late duplicate for a handled task
                    if "err" in out:
                        self._failed_attempt(t, out, queue, waiting)
                        continue
                    t.state = DONE
                    t.result = out["ok"]
                    if t.attempts:
                        t.meta["retries"] = len(t.attempts)
                    if on_done is not None:
                        on_done(t)
                self._drain()
        finally:
            try:
                ex.close()
            finally:
                self._drain()
        return tasks

    def _failed_attempt(self, t: Task, out: dict, queue: deque,
                        waiting: List[Tuple[float, Task]]) -> None:
        attempt = {"attempt": len(t.attempts) + 1,
                   "error": out["err"], "worker": out.get("worker")}
        t.attempts.append(attempt)
        if len(t.attempts) <= self.max_retries:
            t.state = PENDING
            delay = self.retry_backoff * (2 ** (len(t.attempts) - 1))
            self._emit({"event": "task_retry", "task": t.index,
                        "attempt": len(t.attempts),
                        "delay_s": round(delay, 3),
                        "worker": attempt["worker"],
                        "error": _last_line(out["err"])})
            if delay > 0:
                waiting.append((time.monotonic() + delay, t))
            else:
                queue.append(t)
            return
        t.state = FAILED
        t.error = out["err"]
        self._emit({"event": "task_failed", "task": t.index,
                    "attempts": len(t.attempts),
                    "worker": attempt["worker"],
                    "error": _last_line(out["err"])})
        if self.on_failure == "raise":
            history = "\n".join(
                f"  attempt {a['attempt']} on {a['worker'] or 'executor'}: "
                f"{_last_line(a['error'])}" for a in t.attempts)
            raise SchedulerError(
                f"sweep task {t.index} failed after {len(t.attempts)} "
                f"attempt(s):\n{history}\n\nlast traceback:\n{t.error}",
                task=t)
        # on_failure="skip": the task stays FAILED with its history; the
        # caller reports partial results and journals the failure


def run_tasks(tasks: Sequence[Any], runner: Callable[[Any], dict], *,
              workers: int = 1,
              on_result: Callable[[int, dict], None] = None) -> List[dict]:
    """Historical ``repro.api.parallel.run_tasks`` API over the scheduler:
    run ``runner(task) -> json-able dict`` over every task, ``workers`` at
    a time, returning results in task order; ``on_result(index, res)``
    fires as each result lands."""
    tasks = list(tasks)
    if workers <= 1 or len(tasks) <= 1 or not fork_available():
        executor: Executor = InProcessExecutor()
    else:
        executor = ForkExecutor(min(workers, len(tasks)))

    def on_done(t: Task) -> None:
        if on_result is not None:
            on_result(t.index, t.result)

    done = Scheduler(executor, runner).run(tasks, on_done=on_done)
    return [t.result for t in done]
