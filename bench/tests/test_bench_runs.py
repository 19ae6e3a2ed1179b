"""Whole runs of tiny cells on the CPU (the program's plain versions): the
reference against the program, the result's line, the imports, cells and
metrics found by name, and the faults that must make ``correct`` false."""

import argparse
import json
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import cli, serve, train
from bench.tests.tiny import CELLS, make_root

CPU = torch.device("cpu")
# f32 on both sides on the CPU: the program and the reference agree to
# rounding (readings ~1e-7)
LIMITS = {"moe-train": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                        "change_gap": 1e-4},
          "dense-train": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                          "change_gap": 1e-4},
          "moe-serve": {"logit_gap": 1e-4},
          "moe-open": {"logit_gap": 1e-4}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"), LIMITS)


def run(root, cell, trace=0, seed=2**31 + 7, seconds=0.5):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return cli.execute(args, root, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", [c for c, _, _ in CELLS])
def test_program_agrees_with_the_reference(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,trace", [
    ("moe-train", 0), ("moe-train", 1), ("moe-serve", 0), ("moe-serve", 1),
    ("moe-open", 0), ("moe-open", 1)])
def test_result_line(root, cell, trace):
    # a window long enough to complete a request on a loaded CPU
    out = run(root, cell, trace, seconds=2.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    want = {"moe-train": ({"train_tokens_per_s", "setup_s"}, set()),
            "moe-serve": ({"serve_tokens_per_s", "setup_s"},
                          {"decode_step_ms.serve"}),
            "moe-open": ({"ttft_p95_ms", "setup_s"},
                         {"prefill_tokens_per_s.serve"})}[cell][trace]
    assert want <= set(out["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device number is read from a CPU run
        assert not any(k.startswith(("mfu", "idle", "matmul", "flash"))
                       for k in out["metrics"])
    json.dumps(out)


def test_no_card_no_result(root):
    """On a machine without the card the run exits non-zero and prints
    nothing to standard output."""
    p = subprocess.run([sys.executable, str(root.parents[0] / "root" /
                                            "bench" / "run.py"),
                        "--workload", "moe-train", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A directory of BENCHMARK.json and bench/ alone has no program."""
    from bench.tests.tiny import BENCH
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "phi35moe-train-4k", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("names,bad", [
    ({"repro_torch", "repro_torch.models.model", "torch"}, []),
    ({"repro", "repro.models"}, ["repro"]),
    ({"jax._src.core", "numpy"}, ["jax"]),
    ({"jaxlib", "flax.linen", "reprox"}, ["flax", "jaxlib"])])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert cli.forbidden_modules(names) == bad


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    """A fresh process that runs a tiny cell of each kind loads no module
    whose top-level name is jax, jaxlib, flax or repro."""
    repo = cli.Path(cli.__file__).resolve().parents[2]
    code = f"""
import argparse, sys, time
from pathlib import Path
sys.path[:0] = [{str(repo)!r}, {str(repo / "src")!r}]
import torch
from bench.harness import cli
for cell in ("moe-train", "dense-train", "moe-serve", "moe-open"):
    a = argparse.Namespace(workload=cell, seed=3, seconds=0.2, trace=1)
    cli.execute(a, Path({str(root)!r}), torch.device("cpu"),
                time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_a_new_cell_traffic_and_metric_from_new_files_alone(root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new BENCHMARK.json entries run with no edit to any file the
    benchmark has."""
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file() and "__pycache__" not in str(p)}
    cfg = json.loads((root / "bench/configs/tiny-dense.json").read_text())
    cfg.update(name="tiny-dense-2", num_hidden_layers=2, vocab_size=80)
    (root / "bench/configs/tiny-dense-2.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "bench/traffic/tiny-train.json").read_text())
    tr.update(batch=2, seq=12, grad_accum=1)
    (root / "bench/traffic/tiny-train-2.json").write_text(json.dumps(tr))
    (root / "bench/metrics/steps_in_window.x.py").write_text(
        "def read(run):\n    return run.window.get('steps')\n")
    (root / "bench/limits/new-cell.json").write_text(
        json.dumps(LIMITS["dense-train"]))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense-2", "source": "test",
                             "file": "bench/configs/tiny-dense-2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "tiny-dense-2",
                               "traffic": "tiny-train-2", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("new-cell")
    bench["per_layer"].append({
        "name": "steps_in_window.x", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_tokens_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    e2e, per = run(root, "new-cell", 0), run(root, "new-cell", 1)
    assert e2e["correct"] and "train_tokens_per_s" in e2e["metrics"]
    assert per["metrics"]["steps_in_window.x"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


# -- faults: each must make correct false ------------------------------------

def _broken_step(monkeypatch, wrap):
    import repro_torch.train.step as S
    real = S.make_train_step

    def make(*a, **k):
        return wrap(real(*a, **k))
    monkeypatch.setattr(S, "make_train_step", make)


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    def wrap(step):
        def same(params, opt_state, batch):
            _, _, metrics = step(params, opt_state, batch)
            return params, opt_state, metrics
        return same
    _broken_step(monkeypatch, wrap)
    out = run(root, "moe-train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["moe-train", "dense-train"])
def test_half_of_the_batch_left_out(root, monkeypatch, cell):
    def wrap(step):
        def half(params, opt_state, batch):
            n = batch["tokens"].shape[0]
            keep = [r for r in range(n) if r % 2 == 0]
            return step(params, opt_state,
                        {k: v[keep] for k, v in batch.items()})
        return half
    _broken_step(monkeypatch, wrap)
    assert not run(root, cell)["correct"]


def test_a_token_altered_where_it_is_produced(root, monkeypatch):
    from repro_torch.serve.engine import Engine
    real = Engine._sample
    calls = []

    def sample(self, logits):
        tok = real(self, logits)
        calls.append(1)
        return (tok + 1) % logits.shape[-1] if len(calls) % 3 == 0 else tok
    monkeypatch.setattr(Engine, "_sample", sample)
    out = run(root, "moe-serve", seconds=1.0)
    assert not out["correct"]


def test_the_control_fails_where_the_program_passes(tmp_path):
    """The control (the reference in float8 in the program's place) reads
    above the program on the tiny cells, and its training readings fail
    the limits the program meets."""
    from bench import controls
    root = make_root(tmp_path, LIMITS)
    for cell, _, _ in CELLS:
        serving = cell.endswith(("serve", "open"))
        row = controls.readings(cell, [11], 1.5 if serving else 0.0, CPU,
                                root, 1)[0]
        names = [k for k in row if k.startswith("control.")
                 and k[len("control."):] in LIMITS[cell]]
        assert names
        assert any(row[k] > LIMITS[cell][k[len("control."):]]
                   for k in names), row
        assert all(row[k[len("control."):]] <= LIMITS[cell][
            k[len("control."):]] for k in names), row
