"""The port's remote workers (``python -m repro_torch.api.worker``) under
the port's supervisor (``repro_torch.api.WorkerPool``), on the CPU.

The workers import their spec from ``chip_smoke.py`` (``golden_space``:
the golden runner's space through the port's simulator), with ``src`` and
the repository root on ``PYTHONPATH``.  A remote sweep over them equals the
port's serial sweep and the JAX package's serial sweep of
``golden_runner:golden_space`` bit for bit; a worker serving another space
is refused; a chaos kill is survived by a supervised restart and rejoin,
as ``tests/test_faults.py`` shows for the JAX package; and a worker process
loads neither JAX nor the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
KW = dict(policies=["conditional", "eager"], tolerances=[0.25])


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _spec(index: int, **kw):
    from repro_torch.api import WorkerSpec
    return WorkerSpec(spec="chip_smoke:golden_space",
                      spec_args={"index": index},
                      env=_chip_smoke()._worker_env(), **kw)


def _session(space):
    from repro_torch.api import AutotuneSession, SimBackend
    return AutotuneSession(space, backend=SimBackend(), trials=2)


@pytest.fixture(scope="module")
def serial():
    """The port's and the JAX package's serial sweeps of golden study 1."""
    from golden_runner import golden_space as jax_golden_space
    from repro.api import AutotuneSession as JaxSession
    from repro.api import SimBackend as JaxSim
    cs = _chip_smoke()
    port = [cs._strip(r) for r in
            _session(cs.golden_space(1)).sweep(workers=1, **KW)]
    jax = [cs._strip(r) for r in JaxSession(
        jax_golden_space(1), backend=JaxSim(), trials=2).sweep(workers=1,
                                                               **KW)]
    return port, jax


@pytest.fixture(scope="module")
def pool():
    """Three listen-mode port workers: two serve golden study 1, the
    third golden study 0."""
    from repro_torch.api import WorkerPool
    with WorkerPool([_spec(1), _spec(1), _spec(0)],
                    ready_timeout=180) as p:
        yield p


def test_worker_spec_launches_the_ports_worker():
    from repro.api import WorkerSpec as JaxWorkerSpec
    from repro_torch.api import WorkerSpec
    argv = WorkerSpec(spec="chip_smoke:golden_space").argv()
    assert argv[1:3] == ["-m", "repro_torch.api.worker"]
    assert JaxWorkerSpec(spec="x:y").argv()[1:3] == ["-m", "repro.api.worker"]


def test_remote_sweep_equals_serial_and_jax(pool, serial):
    from repro_torch.api import RemoteExecutor, SimBackend
    cs = _chip_smoke()
    space = cs.golden_space(1)
    ex = RemoteExecutor(pool.addresses[:2], expect={
        "space": space.name, "n_points": len(space),
        "backend": SimBackend().fingerprint()})
    got = [cs._strip(r) for r in _session(space).sweep(executor=ex, **KW)]
    port, jax = serial
    assert len(got) == 2
    assert got == port
    assert got == jax


def test_worker_with_the_wrong_spec_is_refused(pool):
    from repro_torch.api import RemoteExecutor, SchedulerError
    space = _chip_smoke().golden_space(1)
    ex = RemoteExecutor(pool.addresses[2:], expect={"space": space.name})
    with pytest.raises(SchedulerError, match="wrong --spec"):
        _session(space).sweep(executor=ex, **KW)


def test_chaos_kill_supervised_restart_completes_bit_identical(tmp_path,
                                                               serial):
    """Chaos kills 1 of 2 port workers on its first task; the supervisor
    restarts it, the killed task is retried, and the sweep lands
    bit-identical to the serial drivers of both packages."""
    from repro_torch.api import RemoteExecutor, WorkerPool
    cs = _chip_smoke()
    space = cs.golden_space(1)
    ex = RemoteExecutor(listen="127.0.0.1:0", join_timeout=120,
                        task_timeout=120, expect={"space": space.name})
    marker = tmp_path / "kill.marker"
    specs = [_spec(1, connect=ex.listen_address,
                   faults={"kill_after": 1, "marker": str(marker)}),
             _spec(1, connect=ex.listen_address)]
    sess = _session(space)
    with WorkerPool(specs, restart_backoff=0.1, ready_timeout=180) as p:
        got = sess.sweep(executor=ex, max_retries=3, **KW)
        assert [cs._strip(r) for r in got] == serial[0] == serial[1]
        assert marker.exists()              # the kill really fired
        recoveries = [r.extra["recovery"] for r in got
                      if "recovery" in r.extra]
        assert recoveries and recoveries[0]["retries"] >= 1
        assert p.restarts() >= 1            # the supervisor brought it back
    assert any(e["event"] == "worker_restart" for e in p.events)
    names = {e["event"] for e in sess.last_sweep_events}
    assert {"worker_joined", "worker_lost", "task_retry"} <= names


_WORKER_IMPORTS = r"""
import sys
from repro_torch.api.worker import arm_program_cache, identity, resolve_spec
from repro_torch.api.session import run_payload
space, backend = resolve_spec("chip_smoke:golden_space", {"index": 1})
arm_program_cache(backend, "mem")
lm_space, lm_backend = resolve_spec(
    "chip_smoke:lm_space", {"reduced": True, "device": "cpu"})
print(identity(space, backend)["space"], identity(lm_space, lm_backend))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_worker_process_loads_neither_jax_nor_the_jax_package():
    """What a worker process imports to serve either spec of chip_smoke.py
    (the golden space; the LM wall-clock study, reduced on the CPU), and
    the identity the LM spec reports, which the driver checks."""
    env = dict(os.environ, **_chip_smoke()._worker_env())
    out = subprocess.run([sys.executable, "-c", _WORKER_IMPORTS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    first, bad = out.stdout.strip().splitlines()[-2:]
    assert first.startswith("golden-capital {'space': 'lm-smollm-135m', "
                            "'n_points': 12, 'backend': {'name': "
                            "'wallclock', 'clock': 'default'}}")
    assert bad == "[]"
