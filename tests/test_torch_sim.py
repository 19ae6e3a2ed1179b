"""The port's copy of the simulator (Critter over the simmpi runtime, the
SLATE/Capital/CANDMC schedules) reproduces the JAX package's protocol.

The port's studies are built from the reference harness's own source
(``tests/golden_runner.py``, and the trace-replay test of
``tests/test_golden_reports.py``) with its ``repro.`` imports rewritten to
``repro_torch.`` by ``test_torch_copies.port_imports``, so both packages
run the same protocol code:

(a) the golden protocol through ``repro_torch`` equals
    ``tests/golden_reports.json`` bit for bit, every study and policy;
(b) a recorded event program replays exactly as fresh generators do;
(c) a ``linalg.studies`` study at ``ci`` scale through ``AutotuneSession``
    + ``SimBackend`` gives the same canonical JSON in both packages (all
    but ``wall_s``, the host time the session took).
"""

import ast
import json
import types
from pathlib import Path

import pytest

from test_torch_copies import port_imports

TESTS = Path(__file__).resolve().parent
GOLDEN = json.loads((TESTS / "golden_reports.json").read_text())
POLICY_NAMES = ["apriori", "conditional", "eager", "local", "online"]


def _ported_module(path: Path, name: str) -> types.ModuleType:
    """``path``'s source with its ``repro.`` imports rewritten, executed
    as module ``name``."""
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    exec(compile(port_imports(path.read_text()), str(path), "exec"),
         mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def port_goldens():
    runner = _ported_module(TESTS / "golden_runner.py",
                            "port_golden_runner")
    # round-trip through JSON so float repr/parse treatment is identical
    return json.loads(json.dumps(runner.compute_goldens()))


def test_golden_policies_are_the_ports():
    from repro_torch.core.policies import POLICIES
    assert sorted(POLICIES) == sorted(POLICY_NAMES)
    assert all(set(GOLDEN[s]) == set(POLICY_NAMES) for s in GOLDEN)


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("study", sorted(GOLDEN))
def test_port_reports_bit_identical_to_goldens(port_goldens, study, policy):
    assert set(port_goldens) == set(GOLDEN)
    want, got = GOLDEN[study][policy], port_goldens[study][policy]
    assert len(got) == len(want)
    for g, n in zip(want, got):
        for field in g:
            assert n[field] == g[field], \
                f"{study}/{policy}/{g['name']}/{field}: " \
                f"{n[field]!r} != {g[field]!r}"


def test_port_trace_replay_is_deterministic():
    """The reference's trace-replay test, run on the port's modules."""
    path = TESTS / "test_golden_reports.py"
    text = path.read_text()
    fn = next(n for n in ast.parse(text).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "test_trace_replay_is_deterministic")
    src = ast.get_source_segment(text, fn)
    ns: dict = {}
    exec(compile(port_imports(src), str(path), "exec"), ns)
    ns["test_trace_replay_is_deterministic"]()


def test_ci_study_session_matches_jax():
    from repro.api import AutotuneSession as JaxSession
    from repro.api import SimBackend as JaxSim
    from repro.api import dumps_canonical as jax_dumps
    from repro.linalg.studies import search_space as jax_space
    from repro_torch.api import AutotuneSession, SimBackend, dumps_canonical
    from repro_torch.linalg.studies import search_space

    port = AutotuneSession(search_space("slate-cholesky", "ci"),
                           backend=SimBackend(), policy="online",
                           tolerance=0.25).run()
    ref = JaxSession(jax_space("slate-cholesky", "ci"), backend=JaxSim(),
                     policy="online", tolerance=0.25).run()
    assert len(port.records) == 20
    # every field but the session's own host wall time
    port_json, ref_json = port.to_json(), ref.to_json()
    assert port_json.pop("wall_s") > 0 and ref_json.pop("wall_s") > 0
    assert dumps_canonical(port_json) == jax_dumps(ref_json)
