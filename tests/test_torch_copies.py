"""The port's copies of the JAX package's NumPy-only modules are the
originals: each file's source equals its original's once the ``repro.``
imports are rewritten to ``repro_torch.`` (and nothing else), and each class
of the ``api/backends.py`` subset has its original's source."""

import ast
import inspect
import re
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
          "api/faults.py", "api/parallel.py",
          # the remote worker (its one nested import rewritten)
          "api/worker.py"]
# copies that also take ``port_module_strings``: the supervisor spawns
# ``python -m repro_torch.api.worker``, not the JAX package's worker
MODULE_STRING_COPIES = ["api/supervisor.py"]
BACKEND_CLASSES = ["Measurement", "BackendRun", "Backend", "SimBackend",
                   "SimRun", "WallClockBackend", "WallClockRun",
                   "DryRunBackend", "DryRunRun", "dryrun_space"]
# what the port still leaves out of repro.api
NOT_PORTED = set()
# a string constant naming a module of the JAX package ("repro.api.worker",
# "repro.linalg.studies:search_space")
MODULE_PATH = re.compile(r"repro(\.[A-Za-z_]\w*)+(:[A-Za-z_]\w*)?")


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


def _docstrings(tree) -> set:
    """ids of the docstring constants of a module, its classes and
    functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant) and \
                    isinstance(first.value.value, str):
                out.add(id(first.value))
    return out


def port_module_strings(text: str) -> str:
    """``text`` with every string constant that names a module path of the
    JAX package (all of it: ``MODULE_PATH``) rewritten from ``repro.`` to
    ``repro_torch.``; docstrings, comments and other strings keep their
    words."""
    tree = ast.parse(text)
    skip = _docstrings(tree)
    lines = text.splitlines(keepends=True)
    hits = sorted(((n.lineno, n.col_offset, n.end_col_offset)
                   for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and id(n) not in skip and n.lineno == n.end_lineno
                   and MODULE_PATH.fullmatch(n.value)), reverse=True)
    for lineno, start, end in hits:     # offsets count UTF-8 bytes
        raw = lines[lineno - 1].encode()
        lit = raw[start:end].replace(b"repro.", b"repro_torch.", 1)
        lines[lineno - 1] = (raw[:start] + lit + raw[end:]).decode()
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


@pytest.mark.parametrize("rel", MODULE_STRING_COPIES)
def test_module_string_copy_equals_original(rel):
    """The copy is the original under both rules, and the string rule
    changed only the worker's module path: one line, one string."""
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == port_module_strings(port_imports(original))
    changed = [(a, b) for a, b in zip(original.splitlines(),
                                      copy.splitlines()) if a != b]
    assert changed == [(a, a.replace('"repro.api.worker"',
                                     '"repro_torch.api.worker"'))
                       for a, _ in changed] and len(changed) == 1
    tree = ast.parse(copy)
    skip = _docstrings(tree)
    assert not [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and id(n) not in skip
                and isinstance(n.value, str)
                and MODULE_PATH.fullmatch(n.value)]


def test_port_module_strings_keeps_docstrings_and_other_strings():
    text = ('"""Runs ``python -m repro.api.worker``."""\n'
            'A = "repro.api.worker"\n'
            'B = "repro-worker-pool"\n'
            'C = ["x", \'repro.linalg.studies:search_space\']  # repro.x\n'
            'def f():\n'
            '    """repro.core"""\n'
            '    return "see repro.api.worker", "repro_torch.api", "reprox"\n')
    assert port_module_strings(text) == text.replace(
        'A = "repro.', 'A = "repro_torch.').replace(
        "'repro.linalg", "'repro_torch.linalg")


@pytest.mark.parametrize("name", BACKEND_CLASSES)
def test_backend_subset_class_equals_original(name):
    import repro.api.backends as jax_backends
    import repro_torch.api.backends as port_backends
    original = inspect.getsource(getattr(jax_backends, name))
    assert inspect.getsource(getattr(port_backends, name)) == \
        port_imports(original)


def test_backend_subset_leaves_out_the_simulator_backends():
    """Every backend of ``backends`` is ported, the dry-run's too (its
    ``DryRunBackend``, ``DryRunRun`` and ``dryrun_space``), and
    ``repro_torch.api`` exports each of them but the runs, as
    ``repro.api`` does."""
    import repro_torch.api as api
    import repro_torch.api.backends as port_backends
    for name in ("DryRunBackend", "DryRunRun", "dryrun_space"):
        assert hasattr(port_backends, name)
    assert {"DryRunBackend", "dryrun_space"} <= set(api.__all__)
    assert set(BACKEND_CLASSES) - {"SimRun", "DryRunRun"} <= set(
        api.__all__)


@pytest.mark.parametrize("package", ["core", "api", "simmpi", "linalg",
                                     "serve"])
def test_package_exports_equal_the_originals(package):
    """Each package exports the reference's names, less what is not
    ported (``api``: the dry-run backend)."""
    import importlib
    original = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    extra = {"WallClockRun"} if package == "api" else set()
    assert set(port.__all__) - extra == set(original.__all__) - NOT_PORTED
    for name in port.__all__:
        assert hasattr(port, name), name
