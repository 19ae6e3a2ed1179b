"""The SSM scans under sharding rules against the JAX package's, on the CPU:
one gloo group of 8 ranks for the module
(``tests/torch_sharded_ssm_ranks.py``, no JAX there), the JAX side on
``tests/conftest.py``'s 8 virtual devices.

- each mixer's block (reduced jamba's Mamba, reduced xlstm-125m's mLSTM
  and sLSTM; 4 x 16 tokens, two chunks of 8) under cp on (2, 4): its
  output and every gradient (A's ``a_log`` and sLSTM's ``r`` among them)
  against ``jax.grad`` of the JAX block under the same rules and against
  the port's block on one rank's plain tensors (1e-5 x scale); with the
  manual region's gradients left at DTensor's default (the forward's
  placements, no share of a replicated output's cotangent) the region's
  weight gradient is wrong;
- one sharded step (ga 2, 4 x 32, AdamW lr 1e-3 warmup 1, ssm_chunk 8) of
  reduced xlstm-125m and jamba under cp, tp and dp against the JAX sharded
  step under the same rules (loss rtol 1e-5; parameters rtol 5e-4, atol
  5e-5);
- the sharded step builds for all ten configurations.
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
from repro.models import ssm as JS
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.parallel import sharding as jax_sharding
from repro.train.optim import AdamWConfig as JaxAdamW
from repro.train.optim import adamw_init as jax_adamw_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import MeshShape, make_rules
from repro_torch.train.step import make_train_step
from test_torch_sharded import LOSS_RTOL, assert_close, load
from test_torch_train import host_batch, numpy_tree, to_jax
import torch_sharded_ranks as SR
import torch_sharded_ssm_ranks as R

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
BLOCK_TOL = 1e-5


def block_inputs():
    """Each mixer's input x and output cotangent g, drawn with numpy."""
    rng = np.random.default_rng(5)
    out = {}
    for mixer, arch, _ in R.MIXERS:
        D = jax_get_config(arch, reduced=True).d_model
        for k in ("x", "g"):
            out[f"{mixer} {k}"] = rng.standard_normal(
                R.BLOCK_SHAPE + (D,)).astype(np.float32)
    return out


def jax_block(mixer, arch, group, inp):
    """(y, {name: gradient}) of sum(block(p, x) * g) in JAX under cp rules
    on (2, 4)."""
    cfg = jax_get_config(arch, reduced=True)
    p = {k[4:]: jnp.asarray(v[0]) for k, v in numpy_tree(arch)[group].items()
         if k.startswith("mix_")}
    fn = {"mamba": JS.mamba_block, "mlstm": JS.mlstm_block,
          "slstm": JS.slstm_block}[mixer]
    g = jnp.asarray(inp[f"{mixer} g"])

    def f(p, x):
        y, _ = fn(p, x, cfg, chunk=SR.KNOBS["ssm_chunk"])
        return jnp.sum(y * g), y
    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    rules = jax_sharding.make_rules("cp").with_mesh(jax_host_mesh(model=4))
    with jax_sharding.axis_rules(rules):
        (_, y), (gp, gx) = vg(p, jnp.asarray(inp[f"{mixer} x"]))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y), grads


def jax_step(arch, variant, batch):
    cfg = jax_get_config(arch, reduced=True)
    tree = jax.tree.map(jnp.asarray, numpy_tree(arch))
    step = jax.jit(jax_make_train_step(
        JaxModel(cfg, JaxKnobs(**SR.KNOBS)),
        jax_sharding.make_rules(variant).with_mesh(jax_host_mesh(model=4)),
        JaxTrainConfig(grad_accum=2, optimizer=JaxAdamW(**SR.OPT))))
    p, _, m = step(tree, jax_adamw_init(tree), to_jax(batch))
    return jax.tree.map(np.asarray, p), float(m["loss"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 ranks, compute the JAX side meanwhile, wait for the
    ranks; everything each test holds against."""
    in_dir = tmp_path_factory.mktemp("ssm_in")
    out_dir = tmp_path_factory.mktemp("ssm_out")
    for arch in R.ARCHS:
        np.savez(in_dir / f"tree_{arch}.npz", **SR.flat(numpy_tree(arch)))
    inp = block_inputs()
    np.savez(in_dir / "blocks.npz", **inp)
    batch = host_batch(R.ARCHS[0], 0, 4, 32)
    np.savez(in_dir / "batches.npz", **batch)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_ssm_ranks.py"),
         str(in_dir), str(out_dir)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        ref = SimpleNamespace(out=out_dir)
        # XLA compiles with the GIL released: three at a time
        with ThreadPoolExecutor(3) as pool:
            blocks = {mixer: pool.submit(jax_block, mixer, arch, group, inp)
                      for mixer, arch, group in R.MIXERS}
            steps = {f"{arch} {v}": pool.submit(jax_step, arch, v, batch)
                     for arch in R.ARCHS for v in R.VARIANTS}
            ref.blocks = {k: f.result() for k, f in blocks.items()}
            ref.steps = {k: f.result() for k, f in steps.items()}
        proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    with np.load(out_dir / "blocks.npz") as z:
        ref.got = {k: z[k] for k in z.files}
    return ref


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("against", ["jax", "one rank"])
@pytest.mark.parametrize("mixer", [m for m, _, _ in R.MIXERS])
def test_block_under_cp(ranks, mixer, against):
    """The block's output and every gradient under cp within 1e-5 x scale
    of JAX's under the same rules, and of the port's block on plain
    tensors."""
    y, grads = ranks.blocks[mixer]
    got = ranks.got
    if against == "one rank":
        y = got[f"{mixer} one y"]
        grads = {k: got[f"{mixer} one d{k}"] for k in grads}
    assert _err(got[f"{mixer} cp y"], y) <= BLOCK_TOL
    for k, w in grads.items():
        assert _err(got[f"{mixer} cp d{k}"], w) <= BLOCK_TOL, k


@pytest.mark.parametrize("mixer", [m for m, _, _ in R.MIXERS])
def test_region_gradients_at_dtensor_default_are_wrong(ranks, mixer):
    """With the region's gradient placements left at the forward's (no
    ``Partial`` over the mesh dims an input is whole on, no share of a
    replicated output's cotangent) the region's weight gradient (Mamba's
    ``a_log``, sLSTM's ``r``, mLSTM's ``wq`` through q, which is whole on
    the model dim where v is split) is wrong; the rule's is right."""
    _, grads = ranks.blocks[mixer]
    k = R.REGION_WEIGHT[mixer]
    assert _err(ranks.got[f"{mixer} cp d{k}"], grads[k]) <= BLOCK_TOL
    assert _err(ranks.got[f"{mixer} default d{k}"], grads[k]) > 0.1


@pytest.mark.parametrize("variant", R.VARIANTS)
@pytest.mark.parametrize("arch", R.ARCHS)
def test_sharded_step_matches_jax(ranks, arch, variant):
    losses = json.loads((ranks.out / "steps.json").read_text())
    p, loss = ranks.steps[f"{arch} {variant}"]
    np.testing.assert_allclose(losses[f"{arch} {variant}"], loss,
                               rtol=LOSS_RTOL)
    assert_close(load(ranks.out / f"step_{arch} {variant}.npz"), p)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_step_admits_every_configuration(arch):
    cfg = get_config(arch, reduced=True)
    make_train_step(Model(cfg, device="cpu"), rules=make_rules(
        "cp").with_mesh(MeshShape(("data", "model"), (2, 4))))
