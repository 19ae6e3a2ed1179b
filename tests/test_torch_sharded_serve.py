"""The serving engine under sharding rules against the JAX package's, on the
CPU: one gloo group of 8 ranks for the module
(``tests/torch_sharded_serve_ranks.py``, no JAX there), the JAX side on
``tests/conftest.py``'s 8 virtual devices.

- the port's ``Engine(..., rules=...)`` on a (2, 4) mesh against the JAX
  ``Engine`` under the same rules (batch 4, s_max 64, 6 new tokens, five
  prompts of 5, 8, 16, 7 and 3 tokens, so the fifth waits for a slot):
  equal greedy tokens for reduced smollm-135m under cp, tp and dp,
  xlstm-125m under cp, deepseek-v2 under cp, jamba under tp and
  musicgen-large (4 codebooks) under cp, and the engine's cache gathered
  within rtol 1e-5 / atol 1e-5 of JAX's;
- jamba under tp: the JAX engine's tokens under the rules differ from its
  tokens without them (the per-shard MoE capacity, ``ROADMAP.md`` queue 3),
  and the port's equal the former;
- the cache's write rules on sharded DTensors: ``write_block`` (the
  prefill's store and the engine's splice) and ``layers.cache_update``
  (one position a row, rows spread over the sequence's shards) equal the
  same writes on whole tensors, bit for bit; in the engine's decode steps
  the writes run no collective and the attention over the sharded cache
  moves only q's heads, the softmax's row maxima and sums and the output's
  partial sums.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.parallel import sharding as jax_sharding
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from test_torch_train import numpy_tree
import torch_sharded_ranks as SR
import torch_sharded_serve_ranks as R

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
CACHE_TOL = 1e-5
QUIRK = ("jamba-v0.1-52b", "tp")


def jax_engine(arch, variant):
    """(tokens per request, the engine's cache as numpy) of the JAX engine
    under ``variant`` on (2, 4) (None: no rules)."""
    cfg = jax_get_config(arch, reduced=True)
    tree = jax.tree.map(jnp.asarray, numpy_tree(arch))
    rules = None if variant is None else jax_sharding.make_rules(
        variant).with_mesh(jax_host_mesh(model=4))
    eng = JaxEngine(JaxModel(cfg, JaxKnobs(**SR.KNOBS)), tree,
                    JaxServeConfig(**R.SERVE), rules=rules)
    for uid, p in enumerate(R.prompts(cfg.vocab, cfg.n_codebooks)):
        eng.submit(JaxRequest(uid, p))
    res = eng.run()
    return ({str(u): r.tokens for u, r in res.items()},
            [np.asarray(leaf) for leaf in jax.tree.leaves(eng.cache)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 ranks, run the JAX engines meanwhile, wait for the
    ranks; everything each test holds against."""
    in_dir = tmp_path_factory.mktemp("serve_in")
    out_dir = tmp_path_factory.mktemp("serve_out")
    for arch in sorted({a for a, _ in R.CASES}):
        np.savez(in_dir / f"tree_{arch}.npz", **SR.flat(numpy_tree(arch)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_serve_ranks.py"),
         str(in_dir), str(out_dir)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        # XLA compiles with the GIL released: three at a time
        with ThreadPoolExecutor(3) as pool:
            runs = {f"{a} {v}": pool.submit(jax_engine, a, v)
                    for a, v in R.CASES + ((QUIRK[0], None),)}
            ref = SimpleNamespace(out=out_dir, jax={
                k: f.result() for k, f in runs.items()})
        proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    ref.tokens = json.loads((out_dir / "tokens.json").read_text())
    return ref


def _leaves(path):
    """The cache's leaves in tree order (keys ``c_i_j...``)."""
    with np.load(path) as z:
        keys = sorted(z.files, key=lambda k: [int(i) for i in
                                               k.split("_")[1:]])
        return [z[k] for k in keys]


@pytest.mark.parametrize("arch,variant", R.CASES)
def test_engine_tokens_match_jax(ranks, arch, variant):
    want, _ = ranks.jax[f"{arch} {variant}"]
    assert ranks.tokens[f"{arch} {variant}"] == want


@pytest.mark.parametrize("arch,variant", R.CASES)
def test_engine_cache_matches_jax(ranks, arch, variant):
    """Every cache leaf gathered within rtol 1e-5 / atol 1e-5 of the JAX
    engine's (slots that finished hold their last request's state in
    both)."""
    _, want = ranks.jax[f"{arch} {variant}"]
    got = _leaves(ranks.out / f"cache_{arch} {variant}.npz")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=CACHE_TOL, atol=CACHE_TOL,
                                   err_msg=f"leaf {i}")


def test_jamba_under_tp_is_the_capacity_quirk(ranks):
    """Reduced jamba's tokens under tp differ from its tokens without rules
    in the JAX package (each token shard has its own MoE capacity), and the
    port's equal JAX's under the rules."""
    under, _ = ranks.jax[f"{QUIRK[0]} {QUIRK[1]}"]
    without, _ = ranks.jax[f"{QUIRK[0]} None"]
    assert under != without
    assert ranks.tokens[f"{QUIRK[0]} {QUIRK[1]}"] == under


@pytest.mark.parametrize("arch,variant", R.CASES)
def test_decode_step_leaves_the_cache_in_place(ranks, arch, variant):
    """The cache is never gathered: its writes (``cache_update``) run no
    collective, and ``decode_attention`` over a cache split on its
    sequence moves only q's heads, the softmax's row maxima and sums and
    the output's partial sums, less than a quarter of the cache's local
    bytes a step (rank 0's collectives counted on the local tensors)."""
    stats = json.loads((ranks.out / "comm.json").read_text())[
        f"{arch} {variant}"]
    assert stats["decode_steps"] > 0 and stats["step"]
    assert stats["cache_update"] == {}
    moved = sum(c["bytes"] for c in stats["decode_attention"].values())
    assert moved < stats["cache_bytes_local"] / 4, stats


@pytest.mark.parametrize("case", range(len(R.WRITE_CASES)))
def test_cache_write_rules(ranks, case):
    """``write_block`` into a sharded cache (and ``cache_update``'s per-row
    write where the cache has a sequence) equal the writes on whole
    tensors bit for bit, and wrote something."""
    got = json.loads((ranks.out / "writes.json").read_text())
    assert got[f"block {case}"] == 0.0 and got[f"block {case} wrote"]
    if f"rows {case}" in got or len(R.WRITE_CASES[case][0]) == 5:
        assert got[f"rows {case}"] == 0.0
