"""Remote sweep worker: ``python -m repro.api.worker``.

Serves scheduler task payloads (see ``repro.api.scheduler.RemoteExecutor``)
over a TCP socket, executing them against a locally-constructed
(space, backend) pair — study spaces carry closures that cannot cross a
wire, so each worker builds its own from an import spec and the scheduler
ships only JSON task descriptions::

    python -m repro.api.worker \\
        --spec 'repro.linalg.studies:search_space' \\
        --spec-args '{"name": "slate-cholesky", "scale": "ci"}' \\
        --port 0

``--spec`` names ``module:function``; called with the ``--spec-args`` JSON
object as keyword arguments it must return a ``SearchSpace`` (measured by a
default ``SimBackend``), a ``(space, backend)`` tuple, or a ``{"space": ...,
"backend": ...}`` dict.  ``--port 0`` binds an ephemeral port; the worker
prints one ``WORKER_READY <host> <port>`` line to stdout once listening,
which launchers (CI smoke, ``repro.api.supervisor.WorkerPool``) parse to
build the ``RemoteExecutor`` address list.

``--connect host:port`` inverts the topology for *elastic join*: instead
of listening, the worker dials a ``RemoteExecutor(listen=...)`` and serves
that single connection (printing ``WORKER_READY connect <addr>``), so
capacity can be added — or supervisor-restarted back — mid-sweep.  The
dial retries until the scheduler starts accepting; when the scheduler
hangs up, the worker exits 0 (a clean end of service, which a supervisor
does not restart).

Protocol (newline-delimited JSON, one request per line):

- ``{"op": "hello"}``              -> worker identity (space name, point
                                      count, backend fingerprint) — the
                                      executor refuses mismatched workers;
- ``{"op": "ping"}``               -> ``{"ok": "pong"}`` (liveness
                                      heartbeat);
- ``{"op": "run", "id", "task"}``  -> ``{"id", "ok": result_json}`` or
                                      ``{"id", "err": traceback}``;
- ``{"op": "shutdown"}``           -> ``{"ok": "bye"}``, then the worker
                                      exits.

The worker serves connections sequentially (one task in flight per worker
is the scheduler's contract; run several workers for parallelism) and
keeps serving after a scheduler disconnects — including a disconnect that
breaks mid-reply (``BrokenPipeError``/``ConnectionResetError`` are
per-connection events, not worker deaths) — unless ``--once`` is given.
Task errors are caught as ``Exception``; ``KeyboardInterrupt`` and
``SystemExit`` terminate the worker itself.

``--faults '<json>'`` arms a ``repro.api.faults.FaultPlan`` for chaos
testing: die or wedge on the Nth task, delay / drop / corrupt replies on
a deterministic schedule.
"""

from __future__ import annotations

import argparse
import importlib
import json
import socket
import sys
import time
import traceback
from typing import Tuple

from .space import SearchSpace


def resolve_spec(spec: str, spec_args: dict) -> Tuple[SearchSpace, object]:
    """Import ``module:function``, call it with ``spec_args``, normalize
    the result to (space, backend)."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"--spec must be 'module:function', got {spec!r}")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    got = fn(**spec_args)
    if isinstance(got, SearchSpace):
        from .backends import SimBackend
        return got, SimBackend()
    if isinstance(got, dict):
        return got["space"], got["backend"]
    space, backend = got
    return space, backend


def arm_program_cache(backend, mode: str) -> None:
    """Give a sim backend a worker-scoped event-program cache
    (``repro.simmpi.program.ProgramCache``), so the structural recording
    pass runs once per unique geometry across ALL tasks this worker
    serves, not once per task.  ``mode`` is ``"mem"`` (in-process LRU) or
    a directory path (crash-atomic on-disk store, sharable between
    workers and across restarts).  No-op for backends without a
    ``program_cache`` attribute (non-sim) or with one already configured
    by the ``--spec`` factory.

    Replay is bit-identical to re-recording (the engine's identity gate),
    which is why the cache never appears in ``identity()`` or the backend
    fingerprint: a cached worker and an uncached one are interchangeable."""
    if getattr(backend, "program_cache", "absent") is None:
        from repro_torch.simmpi.program import ProgramCache
        backend.program_cache = ProgramCache(
            None if mode == "mem" else mode)


def identity(space: SearchSpace, backend) -> dict:
    return {"space": space.name, "n_points": len(space),
            "backend": backend.fingerprint()}


def _handle(conn, space: SearchSpace, backend, run_payload,
            faults=None) -> bool:
    """Serve one connection; returns True when asked to shut down."""
    buf = bytearray()
    with conn:
        while True:
            chunk = conn.recv(1 << 16)
            if not chunk:
                return False
            buf += chunk
            while b"\n" in buf:
                line, _, rest = bytes(buf).partition(b"\n")
                buf[:] = rest
                try:
                    msg = json.loads(line)
                except ValueError:
                    conn.sendall(json.dumps(
                        {"err": "malformed request"}).encode() + b"\n")
                    continue
                op = msg.get("op")
                if op == "hello":
                    reply = {"ok": identity(space, backend)}
                elif op == "ping":
                    reply = {"ok": "pong"}
                elif op == "shutdown":
                    conn.sendall(json.dumps(
                        {"ok": "bye"}).encode() + b"\n")
                    return True
                elif op == "run":
                    if faults is not None:
                        faults.before_task()    # may kill/wedge this worker
                    # Exception, not BaseException: a task failure is a
                    # reply; Ctrl-C / SystemExit must stop the worker
                    try:
                        reply = {"id": msg.get("id"),
                                 "ok": run_payload(space, backend,
                                                   msg["task"])}
                    except Exception:
                        reply = {"id": msg.get("id"),
                                 "err": traceback.format_exc()}
                else:
                    reply = {"err": f"unknown op {op!r}"}
                raw = json.dumps(reply).encode() + b"\n"
                if faults is not None and op == "run":
                    raw = faults.transform_reply(raw)
                    if raw is None:
                        continue                # chaos: reply dropped
                    if not raw.endswith(b"\n"):
                        raw += b"\n"
                conn.sendall(raw)


def serve(space: SearchSpace, backend, *, host: str = "127.0.0.1",
          port: int = 0, once: bool = False,
          ready_out=None, faults=None) -> None:
    """Accept scheduler connections and execute task payloads forever
    (or until a ``shutdown`` request / ``once`` connection closes).

    A connection that breaks mid-exchange (scheduler killed while a reply
    is in flight) is dropped and the worker keeps serving — losing the
    whole worker to one broken socket is exactly the capacity leak the
    fleet scheduler exists to avoid."""
    from .session import run_payload

    srv = socket.create_server((host, port))
    bound_host, bound_port = srv.getsockname()[:2]
    out = ready_out or sys.stdout
    print(f"WORKER_READY {bound_host} {bound_port}", file=out, flush=True)

    with srv:
        while True:
            conn, _ = srv.accept()
            try:
                stop = _handle(conn, space, backend, run_payload, faults)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                print(f"WORKER_CONN_ERROR {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                stop = False
            if stop or once:
                return


def serve_connect(space: SearchSpace, backend, address: str, *,
                  retry_s: float = 0.25, connect_timeout: float = 30.0,
                  ready_out=None, faults=None) -> None:
    """Elastic-join mode: dial a ``RemoteExecutor(listen=...)`` and serve
    that single connection.  Retries the dial until the scheduler accepts
    (a supervisor may launch workers before the sweep starts); exits
    cleanly when the scheduler hangs up."""
    from .session import run_payload

    host, _, port = address.rpartition(":")
    host = host or "127.0.0.1"
    deadline = time.monotonic() + connect_timeout
    while True:
        try:
            conn = socket.create_connection((host, int(port)),
                                            timeout=retry_s + 1.0)
            # the dial timeout must not outlive the dial: a connected
            # worker blocks in recv indefinitely between tasks
            conn.settimeout(None)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise SystemExit(
                    f"could not connect to {address} within "
                    f"{connect_timeout}s")
            time.sleep(retry_s)
    out = ready_out or sys.stdout
    print(f"WORKER_READY connect {address}", file=out, flush=True)
    try:
        _handle(conn, space, backend, run_payload, faults)
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        # the scheduler vanished mid-exchange: end of service, exit clean
        print(f"WORKER_CONN_ERROR {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro.api.worker",
        description="remote sweep worker for repro.api.scheduler")
    ap.add_argument("--spec", required=True,
                    help="module:function returning the space (or "
                         "(space, backend)) this worker serves")
    ap.add_argument("--spec-args", default="{}",
                    help="JSON object of keyword arguments for --spec")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on the "
                         "WORKER_READY line)")
    ap.add_argument("--once", action="store_true",
                    help="exit after the first scheduler disconnects")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="dial a listening RemoteExecutor instead of "
                         "binding a port (elastic join)")
    ap.add_argument("--connect-timeout", type=float, default=30.0,
                    help="give up dialing --connect after this many "
                         "seconds")
    ap.add_argument("--faults", default=None, metavar="JSON",
                    help="chaos-testing FaultPlan (repro.api.faults)")
    ap.add_argument("--program-cache", default="mem", metavar="MODE",
                    help='event-program cache for sim backends: "mem" '
                         "(default: in-process LRU shared across every "
                         'task this worker serves), "off", or a directory '
                         "path for the crash-atomic on-disk store "
                         "(sharable between workers and across restarts)")
    args = ap.parse_args(argv)
    faults = None
    if args.faults:
        from .faults import FaultPlan
        faults = FaultPlan.from_json(json.loads(args.faults))
    space, backend = resolve_spec(args.spec, json.loads(args.spec_args))
    if args.program_cache != "off":
        arm_program_cache(backend, args.program_cache)
    if args.connect:
        serve_connect(space, backend, args.connect,
                      connect_timeout=args.connect_timeout, faults=faults)
    else:
        serve(space, backend, host=args.host, port=args.port,
              once=args.once, faults=faults)


if __name__ == "__main__":
    main()
