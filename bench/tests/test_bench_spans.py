"""The per-layer metrics that read the program's own spans and counters
(``bench/harness/spans.py``), on tiny cells on the CPU: a traced run reports
the host-read ones of its cell, no device-ms one (no card), and an untraced
run none of them."""

import argparse
import time

import pytest
import torch

from bench.harness import cli
from bench.tests.tiny import make_root

SPAN_METRICS = {"sample_ms.serve", "moe_ms.decode", "expert_fill.decode",
                "expert_fill.prefill", "expert_fill.train", "forward_ms.train",
                "backward_ms.train", "optimizer_ms.train"}
DEVICE_MS = {"moe_ms.decode", "forward_ms.train", "backward_ms.train",
             "optimizer_ms.train"}
HOST_READ = {"moe-train": {"expert_fill.train"},
             "moe-serve": {"sample_ms.serve", "expert_fill.decode"},
             "moe-open": {"expert_fill.prefill"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace):
    args = argparse.Namespace(workload=cell, seed=2**31 + 11, seconds=1.0,
                              trace=trace)
    return cli.execute(args, root, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", sorted(HOST_READ))
def test_a_traced_run_reports_its_cells_span_metrics(root, cell):
    got = set(run(root, cell, 1)["metrics"]) & SPAN_METRICS
    assert got == HOST_READ[cell]
    assert not got & DEVICE_MS


@pytest.mark.parametrize("cell", sorted(HOST_READ))
def test_an_untraced_run_reports_none(root, cell):
    run(root, cell, 1)      # the program's records of a traced run, kept
    assert not set(run(root, cell, 0)["metrics"]) & SPAN_METRICS


def test_the_readings(root):
    m = run(root, "moe-serve", 1)["metrics"]
    # 4 slots x top-2 = 8 pairs over 4 experts at factor 2: 4 rows each,
    # all kept
    assert m["expert_fill.decode"]["value"] == pytest.approx(50.0)
    assert m["sample_ms.serve"]["value"] > 0
    m = run(root, "moe-open", 1)["metrics"]
    assert 0 < m["expert_fill.prefill"]["value"] <= 100
    m = run(root, "moe-train", 1)["metrics"]
    assert 0 < m["expert_fill.train"]["value"] <= 100
