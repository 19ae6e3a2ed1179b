"""Worker fleet supervision: launch, monitor, restart.

``WorkerPool`` owns a fleet of ``python -m repro.api.worker`` subprocesses
described by ``WorkerSpec``s: it launches them, waits for their
``WORKER_READY`` lines, and — the fault-tolerance half — watches for
crashes and relaunches crashed workers with exponential backoff, so fleet
capacity recovers instead of monotonically shrinking.

Two topologies:

- **listen-mode** workers (``WorkerSpec(connect=None)``) bind their own
  ports; ``pool.addresses`` (parsed from the ready lines) feeds
  ``RemoteExecutor(addresses)``.  A restarted listen-mode worker binds a
  *new* ephemeral port, which an already-running executor will not find —
  use this mode for static fleets launched before the sweep.
- **connect-mode** workers (``connect="host:port"``) dial a
  ``RemoteExecutor(listen=...)``; a restarted worker simply re-dials, so
  the executor re-admits it mid-sweep (elastic rejoin).  This is the
  fault-tolerant pairing::

      ex = RemoteExecutor(listen="127.0.0.1:0", join_timeout=60)
      specs = [WorkerSpec(spec="repro.linalg.studies:search_space",
                          spec_args={"name": "slate-cholesky",
                                     "scale": "ci"},
                          connect=ex.listen_address)] * 4
      with WorkerPool(specs) as pool:
          results = session.sweep(executor=ex, max_retries=3)

Restart policy: only *nonzero* exits are restarted — a worker exiting 0
ended service deliberately (scheduler hangup in connect mode, ``shutdown``
op) and relaunching it would just churn dials against a closed executor.
Each slot gets ``max_restarts`` relaunches with delay
``restart_backoff * 2**n``; every restart is journaled in ``pool.events``
(and through ``on_event``), so a sweep checkpoint can attribute anomalies
to infrastructure.

Worker stdout/stderr go to per-slot log files (``pool.log_dir``) rather
than pipes — a chatty worker can never deadlock the supervisor on a full
pipe buffer, and crash forensics survive the process.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

READY_RE = re.compile(r"WORKER_READY (\S+) (\S+)")


@dataclass
class WorkerSpec:
    """How to launch one ``python -m repro.api.worker`` process."""

    spec: str                                 # module:function space spec
    spec_args: dict = field(default_factory=dict)
    host: str = "127.0.0.1"                   # listen mode bind host
    port: int = 0                             # listen mode port (0 = any)
    connect: Optional[str] = None             # RemoteExecutor listen addr
    once: bool = False
    faults: Optional[dict] = None             # chaos FaultPlan JSON
    env: Optional[dict] = None                # extra environment entries
    python: str = sys.executable

    def argv(self) -> List[str]:
        cmd = [self.python, "-m", "repro_torch.api.worker",
               "--spec", self.spec,
               "--spec-args", json.dumps(self.spec_args)]
        if self.connect:
            cmd += ["--connect", self.connect]
        else:
            cmd += ["--host", self.host, "--port", str(self.port)]
            if self.once:
                cmd += ["--once"]
        if self.faults:
            cmd += ["--faults", json.dumps(self.faults)]
        return cmd


class WorkerPool:
    """Launch and supervise a fleet of worker subprocesses.

    ``specs`` is one ``WorkerSpec`` per worker (or a single spec and
    ``n=`` copies of it).  ``start()`` launches every worker and blocks
    until each prints ``WORKER_READY`` (``ready_timeout``); a monitor
    thread then restarts crashed workers until ``stop()`` (also the
    context-manager exit).  ``addresses`` lists the listen-mode workers'
    ``host:port`` endpoints."""

    def __init__(self, specs: Union[WorkerSpec, Sequence[WorkerSpec]],
                 n: Optional[int] = None, *,
                 ready_timeout: float = 30.0, max_restarts: int = 3,
                 restart_backoff: float = 0.25,
                 on_event: Optional[Callable[[dict], None]] = None,
                 log_dir: Optional[str] = None):
        if isinstance(specs, WorkerSpec):
            specs = [specs] * (n if n is not None else 1)
        elif n is not None and len(specs) != n:
            raise ValueError(f"got {len(specs)} specs but n={n}")
        if not specs:
            raise ValueError("WorkerPool needs at least one WorkerSpec")
        self.ready_timeout = ready_timeout
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.on_event = on_event
        self.log_dir = log_dir
        self.events: List[dict] = []
        self._slots = [{"spec": s, "proc": None, "logf": None, "log": None,
                        "pos": 0, "restarts": 0, "address": None}
                       for s in specs]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- events

    def _emit(self, event: dict) -> None:
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "WorkerPool":
        if self.log_dir is None:
            self.log_dir = tempfile.mkdtemp(prefix="repro-worker-pool-")
        os.makedirs(self.log_dir, exist_ok=True)
        for i in range(len(self._slots)):
            self._launch(i)
        for i in range(len(self._slots)):
            self._wait_ready(i)
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="repro-worker-pool")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            for slot in self._slots:
                proc = slot["proc"]
                if proc is not None and proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=10)
                if slot["logf"] is not None:
                    slot["logf"].close()
                    slot["logf"] = None

    def __enter__(self) -> "WorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ internals

    def _launch(self, i: int) -> None:
        slot = self._slots[i]
        spec: WorkerSpec = slot["spec"]
        if slot["logf"] is not None:
            slot["logf"].close()
        log_path = os.path.join(self.log_dir, f"worker-{i}.log")
        logf = open(log_path, "ab")
        slot["log"] = log_path
        slot["logf"] = logf
        slot["pos"] = logf.tell()     # this incarnation's output starts here
        env = dict(os.environ)
        if spec.env:
            env.update(spec.env)
        slot["proc"] = subprocess.Popen(
            spec.argv(), stdout=logf, stderr=logf, env=env)

    def _scan_ready(self, slot: dict) -> Optional[re.Match]:
        with open(slot["log"], "rb") as f:
            f.seek(slot["pos"])
            data = f.read().decode(errors="replace")
        return READY_RE.search(data)

    def _tail(self, slot: dict, n: int = 20) -> str:
        try:
            with open(slot["log"], "rb") as f:
                data = f.read().decode(errors="replace")
            return "\n".join(data.splitlines()[-n:])
        except OSError:
            return "<no log>"

    def _wait_ready(self, i: int) -> None:
        slot = self._slots[i]
        deadline = time.monotonic() + self.ready_timeout
        while time.monotonic() < deadline:
            m = self._scan_ready(slot)
            if m is not None:
                host, second = m.group(1), m.group(2)
                slot["address"] = None if host == "connect" \
                    else f"{host}:{second}"
                return
            if slot["proc"].poll() is not None:
                raise RuntimeError(
                    f"worker {i} exited (code {slot['proc'].returncode}) "
                    f"before WORKER_READY:\n{self._tail(slot)}")
            time.sleep(0.05)
        raise RuntimeError(
            f"worker {i} not ready within {self.ready_timeout}s:\n"
            f"{self._tail(slot)}")

    def _monitor(self) -> None:
        while not self._stop.is_set():
            for i, slot in enumerate(self._slots):
                proc = slot["proc"]
                if proc is None or proc.poll() is None:
                    continue
                code = proc.returncode
                if code == 0:
                    # clean exit = deliberate end of service; no restart
                    slot["proc"] = None
                    self._emit({"event": "worker_done", "slot": i})
                    continue
                if slot["restarts"] >= self.max_restarts:
                    slot["proc"] = None
                    self._emit({"event": "worker_gave_up", "slot": i,
                                "exit": code,
                                "restarts": slot["restarts"]})
                    continue
                delay = self.restart_backoff * (2 ** slot["restarts"])
                slot["restarts"] += 1
                self._emit({"event": "worker_restart", "slot": i,
                            "exit": code, "attempt": slot["restarts"],
                            "delay_s": round(delay, 3)})
                if self._stop.wait(delay):
                    return
                with self._lock:
                    if self._stop.is_set():
                        return
                    self._launch(i)
            if self._stop.wait(0.1):
                return

    # ------------------------------------------------------------- queries

    @property
    def addresses(self) -> List[str]:
        """``host:port`` endpoints of the listen-mode workers (ready-line
        parsed; connect-mode workers have no address — they dial in)."""
        return [s["address"] for s in self._slots
                if s["address"] is not None]

    @property
    def alive(self) -> int:
        """Number of currently-running worker processes."""
        return sum(1 for s in self._slots
                   if s["proc"] is not None and s["proc"].poll() is None)

    def restarts(self) -> int:
        """Total restarts performed across all slots."""
        return sum(s["restarts"] for s in self._slots)
