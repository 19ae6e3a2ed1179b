"""The port's dry-run (``launch/{trace_cost,cells,dryrun,mesh}.py``,
``tune/dryrun_search.py``, ``api.DryRunBackend``) against the JAX
package's, on the CPU: fake process groups in-process, each destroyed
after its test; the JAX side on ``tests/conftest.py``'s 8 virtual devices,
traced or sharded, never compiled.

- the counter: ``tests/test_analysis.py``'s cases on the port's
  ``cost_of`` (a product's dot flops exactly, a loop of 10 products 10
  times, a checkpointed gradient at least the plain one, a sharded
  product's all-reduce 10 times in a loop at 10 times one's bytes);
- a kernel op on fake tensors charges its own cost (flash attention: the
  causal pairs) and makes no plain call and no launch; the MoE's expert
  counts keep a static shape and equal ``bincount``'s;
- ``model_flops`` of all 32 cells equals the reference's;
- a reduced train cell of each family on a (2, 4) mesh: the per-device
  bytes of the parameters, the AdamW state and the batch equal the JAX
  cell's (summed from its shardings' shard shapes); the port's dot flops
  beside JAX's ``cost_of`` (printed, with their ratio: ``-s``);
- ``dryrun_search`` and a session over ``dryrun_space`` with
  ``DryRunBackend`` rank the same cached records in the same order as the
  JAX package's;
- the CLI on smollm-135m x decode_32k on the single-pod mesh, in a
  subprocess; importing the dry-run opens no process group.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode

import importlib

import repro.api as jax_api
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import Shape as JaxShape
from repro.launch import cells as jax_cells
from repro.launch.jaxpr_cost import cost_of as jax_cost_of
from repro.launch.mesh import make_host_mesh as jax_host_mesh
import repro_torch.api as api
from repro_torch.configs import SHAPES, Shape, all_cells, get_config
from repro_torch.kernels import cost, ops
from repro_torch.launch import cells
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.trace_cost import cost_of, trace
from repro_torch.models import moe

# the modules (each package's ``tune`` exports a function of this name)
dryrun_search = importlib.import_module("repro_torch.tune.dryrun_search")
jax_search = importlib.import_module("repro.tune.dryrun_search")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

SRC = Path(__file__).resolve().parents[1] / "src"


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("through", ["aten", "kernel"])
def test_cost_exact_matmul(through):
    mm = (lambda a, b: a @ b) if through == "aten" else ops.matmul
    c = cost_of(mm, meta(64, 128), meta(128, 32))
    assert c.dot_flops == 2 * 64 * 128 * 32


def test_cost_loop_multiplies():
    def f(ws, x):
        for w in ws.unbind(0):
            x = x @ w
        return x
    c = cost_of(f, meta(10, 64, 64), meta(4, 64))
    assert c.dot_flops == 10 * 2 * 4 * 64 * 64


def test_cost_counts_remat():
    from torch.utils.checkpoint import checkpoint

    def loss(y):
        return ((y @ y) ** 2).sum()

    def plain(x):
        y = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss(y), y)[0]

    def remat(x):
        y = x.detach().requires_grad_(True)
        return torch.autograd.grad(checkpoint(loss, y, use_reentrant=False),
                                   y)[0]
    base = cost_of(plain, meta(32, 32))
    rem = cost_of(remat, meta(32, 32))
    assert rem.dot_flops >= base.dot_flops     # recompute visible
    assert rem.dot_flops > base.dot_flops


def _sharded_loop(n):
    def f(ws, x):
        mesh = ws.device_mesh
        h = x
        for w in list(ws.unbind(0))[:n]:
            y = (h @ w).redistribute(mesh, (Shard(1),))
            h = (y @ w.T).redistribute(mesh, (Replicate(),))
        return h
    return f


def test_trip_aware_collectives():
    """The reference's ``test_trip_aware_collectives``: a product sharded
    over 8 ranks whose second half sums over them, in a loop of 10: 10
    all-reduces of 10 times one's bytes."""
    with fake_world(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
        with FakeTensorMode():
            W = distribute_tensor(torch.empty(10, 64, 64), mesh,
                                  (Shard(2),), src_data_rank=None)
            x = distribute_tensor(torch.empty(4, 64), mesh, (Replicate(),),
                                  src_data_rank=None)
        _, one = trace(_sharded_loop(1), W, x)
        _, ten = trace(_sharded_loop(10), W, x)
    assert not dist.is_initialized()
    assert one.collectives.count_by_kind == {"all-reduce": 1}
    assert ten.collectives.count_by_kind == {"all-reduce": 10}
    assert ten.collectives.bytes_by_kind["all-reduce"] == \
        10 * one.collectives.bytes_by_kind["all-reduce"] == 10 * 4 * 64 * 4
    # each rank's products are 1/8 of the global ones
    assert ten.cost.dot_flops == 10 * 2 * (2 * 4 * 64 * 8)


def test_flash_on_fake_tensors_charges_its_cost_and_no_plain_call():
    """Forward and backward: the kernel's bytes and the causal pairs' flops
    (``kernels/cost.py``, the formula of ``chip_smoke.py``'s rows), no
    plain version and no launch."""
    q, k, v = meta(2, 48, 4, 16, grad=True), meta(2, 48, 2, 16, grad=True), \
        meta(2, 48, 2, 16, grad=True)

    def fb(q, k, v):
        o = ops.flash_attention(q, k, v)
        return torch.autograd.grad(o.sum(), (q, k, v))
    plain, launched = dict(ops.plain_calls), dict(ops.launches)
    _, tr = trace(fb, q, k, v)
    assert ops.plain_calls == plain and ops.launches == launched
    pairs = 2 * 4 * sum(min(48, i + 1) for i in range(48))
    assert cost.causal_pairs(48, 48) * 2 * 4 == pairs
    assert tr.kernels.flops == {"flash_attention": 2 * (16 + 16) * pairs,
                                "flash_attention_bwd": (6 * 16 + 4 * 16)
                                * pairs}
    assert tr.kernels.bytes["flash_attention"] == cost.kernel_cost(
        "flash_attention", (q, k, v))[0]
    assert tr.kernels.calls == {"flash_attention": 1,
                                "flash_attention_bwd": 1}
    # the plain version's S x S scores are never charged
    assert "bmm" not in tr.ops and "_softmax" not in tr.ops


@pytest.mark.parametrize("sq,skv", [(1, 1), (31, 31), (4, 9), (9, 4),
                                    (128, 4096), (0, 5)])
def test_causal_pairs_closed_form(sq, skv):
    """The default (queries at the end of the keys) and every offset from
    before the first key to past the last: the sum over the rows."""
    assert cost.causal_pairs(sq, skv) == sum(
        max(0, min(skv, skv - sq + i + 1)) for i in range(sq))
    offsets = sorted({-sq - 1, -1, 0, 1, skv // 3, skv - sq, skv - 1, skv,
                      skv + 2})
    for off in offsets:
        assert cost.causal_pairs(sq, skv, off) == sum(
            max(0, min(skv, off + i + 1)) for i in range(sq)), off


def test_cp_trace_charges_the_heaviest_query_shard(monkeypatch):
    """Reduced smollm-135m's tiny train cell under cp on (2, 4): q stays
    split on the sequence (32 positions, 8 a rank) and each flash call is
    charged the pairs of the last shard (offset 24, the rank the step waits
    on), not the whole sequence's nor rank 0's own."""
    name, seq, batch = TINY
    monkeypatch.setitem(SHAPES, name, Shape(name, seq, batch, "train"))
    monkeypatch.setattr(cells, "get_config",
                        lambda a: get_config(a, reduced=True))
    seen = []
    local = ops._flash_local

    def spy(q, k, v, causal, bk, scale, q_offset=None):
        seen.append((q.shape[1], k.shape[1], q_offset))
        return local(q, k, v, causal, bk, scale, q_offset)
    monkeypatch.setattr(ops, "_flash_local", spy)
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        cell = cells.build_cell("smollm-135m", name, mesh)
        tr = cell.trace()[1]
    assert not dist.is_initialized()
    cfg = get_config("smollm-135m", reduced=True)
    n = seq // 4
    assert seen and set(seen) == {(n, seq, seq - n)}
    calls = tr.kernels.calls["flash_attention"]
    # a microbatch's rows on a rank: the batch over ga and the data axis
    B = batch // cells.DRYRUN_TRAIN.grad_accum // 2
    per_call = 2 * 2 * cfg.head_dim * cfg.n_heads * B
    assert tr.kernels.flops["flash_attention"] == \
        calls * per_call * cost.causal_pairs(n, seq, seq - n)
    assert tr.kernels.flops["flash_attention_bwd"] == \
        tr.kernels.calls["flash_attention_bwd"] * 10 * cfg.head_dim \
        * cfg.n_heads * B * cost.causal_pairs(n, seq, seq - n)
    # rank 0's shard would see 36 of the 528 pairs, the whole sequence 528
    assert cost.causal_pairs(n, seq, 0) < cost.causal_pairs(n, seq, seq - n) \
        < cost.causal_pairs(seq, seq)


def test_moe_counts_static_shape_equal_bincount():
    """The sort dispatch's expert counts are a scatter (a static shape the
    fake trace keeps) equal to ``bincount``'s, so its plan and the
    engine's tokens are unchanged."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 6, (40, 2)))
    order, slot, keep = moe._plan(idx, 8, 7)
    fidx = idx.reshape(-1)
    counts = torch.bincount(fidx, minlength=8)
    starts = torch.cumsum(counts, 0) - counts
    se = fidx[order]
    pos = torch.arange(fidx.numel()) - starts[se]
    assert torch.equal(slot, se * 7 + pos) and torch.equal(keep, pos < 7)
    with FakeTensorMode() as m:
        f = moe._plan(m.from_tensor(idx), 8, 7)
    assert tuple(f[1].shape) == (80,)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", all_cells())
def test_model_flops_equal_the_reference(arch, shape):
    assert cells.model_flops(get_config(arch), SHAPES[shape]) == \
        jax_cells.model_flops(jax_get_config(arch), JAX_SHAPES[shape])


FAMILY_ARCHS = ["smollm-135m", "phi3.5-moe", "internvl2-2b",
                "jamba-v0.1-52b", "musicgen-large", "xlstm-125m"]
# the families whose tiny cell the test also traces (the SSM scans run
# their steps one by one, which a fake trace takes a minute over:
# scripts/dryrun_dot_flops.py traces every family)
TRACED = ("smollm-135m", "phi3.5-moe", "internvl2-2b", "musicgen-large")
TINY = ("tiny_train", 32, 8)      # name, seq, global batch


def _jax_bytes(tree, shardings):
    leaves = jax.tree.leaves(tree)
    sh = jax.tree.leaves(shardings,
                         is_leaf=lambda s: hasattr(s, "shard_shape"))
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(leaves, sh))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_cell_argument_bytes_equal_jax(arch, monkeypatch):
    """The per-device bytes of the parameters, AdamW state and batch of a
    reduced train cell on (2, 4) equal the JAX cell's, summed from its
    shardings' shard shapes (nothing compiled); where traced, the port's
    dot flops beside JAX's ``cost_of`` (printed)."""
    name, seq, batch = TINY
    monkeypatch.setitem(SHAPES, name, Shape(name, seq, batch, "train"))
    monkeypatch.setitem(JAX_SHAPES, name, JaxShape(name, seq, batch,
                                                   "train"))
    monkeypatch.setattr(cells, "get_config",
                        lambda a: get_config(a, reduced=True))
    monkeypatch.setattr(jax_cells, "get_config",
                        lambda a: jax_get_config(a, reduced=True))
    jcell = jax_cells.build_cell(arch, name, jax_host_mesh(model=4))
    want = {k: _jax_bytes(a, s) for k, a, s in zip(
        ("params", "opt_state", "batch"), jcell.args, jcell.in_shardings)}
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        cell = cells.build_cell(arch, name, mesh)
        got = cell.argument_bytes()
        tr = cell.trace()[1] if arch in TRACED else None
    assert not dist.is_initialized()
    assert got == want
    if tr is None:
        return
    jax_dot = jax_cost_of(jcell.fn, *jcell.args).dot_flops
    port_dot = tr.cost.dot_flops * 8
    print(f"\n[dryrun] {arch} tiny train (8 x {seq}, ga 4, (2, 4)): dot "
          f"flops port {port_dot:.4e} (8 x rank 0's) JAX {jax_dot:.4e} "
          f"ratio {port_dot / jax_dot:.3f}; kernels {tr.kernels.calls}")
    assert port_dot > 0 and tr.kernels.calls.get("matmul", 0) > 0


# ---------------------------------------------------------------------------
# search and session
# ---------------------------------------------------------------------------

POINTS = [("a", 0.030, True), ("b", 0.010, True), ("c", 0.005, False),
          ("d", 0.020, True), ("e", 0.015, True)]


def _cache(tmp_path):
    """One cached record per point, shared by both packages."""
    for name, step_s, fits in POINTS:
        rec = {"tag": f"smollm-135m_train_4k_{name}_single",
               "roofline": {"step_s": step_s}, "fits": fits,
               "live_bytes": 1, "collective_by_kind": {}}
        (tmp_path / f"{rec['tag']}.json").write_text(json.dumps(rec))
    return str(tmp_path)


def test_search_ranks_cached_records_as_jax(tmp_path):
    d = _cache(tmp_path)
    port = dryrun_search.dryrun_search(
        "smollm-135m", "train_4k",
        [dryrun_search.SearchPoint(n) for n, _, _ in POINTS], cache_dir=d)
    ref = jax_search.dryrun_search(
        "smollm-135m", "train_4k",
        [jax_search.SearchPoint(n) for n, _, _ in POINTS], cache_dir=d)
    order = [r["tag"] for r in port]
    assert order == [r["tag"] for r in ref]
    assert order[-1].endswith("_c_single")     # unfitting sorts last


def test_session_ranks_cached_records_as_jax(tmp_path):
    d = _cache(tmp_path)

    def ranked(pkg, search):
        pts = [search.SearchPoint(n) for n, _, _ in POINTS]
        res = pkg.AutotuneSession(
            pkg.dryrun_space("smollm-135m", "train_4k", pts),
            backend=pkg.DryRunBackend("smollm-135m", "train_4k",
                                      cache_dir=d),
            policy="conditional", tolerance=0.25, trials=1).run()
        return [(r.name, r.predicted) for r in
                sorted(res.records, key=lambda r: r.predicted)]
    got = ranked(api, dryrun_search)
    assert got == ranked(jax_api, jax_search)
    assert [n for n, _ in got] == ["c", "b", "e", "d", "a"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads((tmp_path / "smollm-135m_decode_32k_single.json")
                     .read_text())
    assert rec["mesh"] == [16, 16] and rec["chips"] == 256
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["fits"] is True and mem["card_memory_bytes"] > 0
    assert rec["kernels"]["matmul"]["calls"] > 0
    assert "flash_attention" not in rec["kernels"]   # decode: plain
    assert rec["collectives"]["total_bytes_per_dev"] > 0
    assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
    assert rec["trace_s"] > 0


def test_import_opens_no_process_group():
    code = ("import torch.distributed as d; "
            "import repro_torch.launch.dryrun, repro_torch.tune; "
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(SRC)),
                         timeout=120)
    assert out.stdout.strip() == "False", out.stderr[-2000:]


def test_the_roofline_reads_the_h100s_peaks():
    """989e12 bf16 flop/s, 3.35e12 B/s, a 50e9 B/s link: one second of
    each term at those rates."""
    from repro_torch.launch.trace_cost import roofline_terms
    t = roofline_terms(989e12, 3.35e12, 50e9)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1, 1, 1)
    assert cost.CARD_MEMORY_BYTES == 85_017_493_504
