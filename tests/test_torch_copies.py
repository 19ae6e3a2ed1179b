"""The port's copies of the JAX package's NumPy-only modules are the
originals: each file's source equals its original's once the ``repro.``
imports are rewritten to ``repro_torch.`` (and nothing else), and each class
of the ``api/backends.py`` subset has its original's source."""

import ast
import inspect
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = ["core/signatures.py", "core/stats.py", "core/policies.py",
          "tune/selective.py", "api/serialize.py", "api/space.py",
          "api/result.py", "api/search.py", "api/scheduler.py",
          "api/transfer.py", "api/session.py",
          # the always-on tuning daemon
          "api/daemon.py",
          # the simulator's engine, its studies and the fleet harness
          "core/channels.py", "core/models.py", "core/pathset.py",
          "core/critter.py", "core/tuner.py", "core/__init__.py",
          "simmpi/ops.py", "simmpi/comm.py", "simmpi/costmodel.py",
          "simmpi/program.py", "simmpi/runtime.py", "simmpi/__init__.py",
          "linalg/slate_cholesky.py", "linalg/slate_qr.py",
          "linalg/capital_cholesky.py", "linalg/candmc_qr.py",
          "linalg/studies.py", "linalg/__init__.py",
          "api/faults.py", "api/parallel.py"]
BACKEND_CLASSES = ["Measurement", "BackendRun", "Backend", "SimBackend",
                   "SimRun", "WallClockBackend", "WallClockRun"]
# what the port still leaves out of repro.api
NOT_PORTED = {"DryRunBackend", "dryrun_space", "WorkerPool", "WorkerSpec"}


def port_imports(text: str) -> str:
    """``text`` with every absolute ``from repro...`` import statement
    rewritten to ``from repro_torch...``; docstrings and comments keep
    their words."""
    lines = text.splitlines(keepends=True)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            assert not any(a.name.split(".")[0] == "repro"
                           for a in node.names), "plain import of repro"
        if (isinstance(node, ast.ImportFrom) and node.level == 0
                and node.module.split(".")[0] == "repro"):
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = lines[i].replace("from repro.", "from repro_torch.",
                                            1)
    return "".join(lines)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == port_imports(original)
    # and the rewrite left no import of the JAX package behind
    for node in ast.walk(ast.parse(copy)):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] != "repro"


@pytest.mark.parametrize("name", BACKEND_CLASSES)
def test_backend_subset_class_equals_original(name):
    import repro.api.backends as jax_backends
    import repro_torch.api.backends as port_backends
    original = inspect.getsource(getattr(jax_backends, name))
    assert inspect.getsource(getattr(port_backends, name)) == \
        port_imports(original)


def test_backend_subset_leaves_out_the_simulator_backends():
    """The dry-run backend (HLO lowering) is the part of ``backends`` the
    port leaves out; the simulator's ``SimBackend`` is ported."""
    import repro_torch.api as api
    import repro_torch.api.backends as port_backends
    for name in ("DryRunBackend", "DryRunRun", "dryrun_space"):
        assert not hasattr(port_backends, name)
        assert not hasattr(api, name)
    assert set(BACKEND_CLASSES) - {"SimRun"} <= set(api.__all__)


@pytest.mark.parametrize("package", ["core", "api", "simmpi", "linalg",
                                     "serve"])
def test_package_exports_equal_the_originals(package):
    """Each package exports the reference's names, less what is not
    ported (``api``: the dry-run backend, the worker pool)."""
    import importlib
    original = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    extra = {"WallClockRun"} if package == "api" else set()
    assert set(port.__all__) - extra == set(original.__all__) - NOT_PORTED
    for name in port.__all__:
        assert hasattr(port, name), name
