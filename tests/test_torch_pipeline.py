"""The port's GPipe pipeline over 'pod' (``parallel/pipeline.py``) against
the JAX package's, on the CPU: one gloo group of 8 ranks
(``tests/torch_pipeline_ranks.py``, no JAX there), the JAX side on
``tests/conftest.py``'s 8 virtual devices.

The reference test's input (``tests/test_sharded.py``
``test_pipeline_parallel_matches_reference``): reduced smollm-135m under
``ModelKnobs(kv_chunk=16, ssm_chunk=8)``, its JAX init, 8 x 32 tokens,
``n_mb`` 4, the cp rules.  The port's loss and every gradient on (pod 2,
data 2, model 2) and on (pod 1, data 4, model 2) are held against JAX's
``model.loss`` and JAX's ``pipeline_loss`` on (2, 2, 2) with the reference
test's tolerances (loss rtol 2e-3, gradients rtol 5e-3 / atol 1e-4); the
gaps measured are printed (``-s``).  On (1, 1, 1) in a world-1 group the
pipeline equals ``Model.loss`` on the same microbatches, with the same
plain calls.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.parallel import pipeline as jax_pipeline
from repro.parallel.sharding import make_rules as jax_make_rules
from repro_torch.parallel import pipeline
from repro_torch.parallel.sharding import MeshShape, make_rules
import torch_pipeline_ranks as R

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
LOSS_RTOL, G_RTOL, G_ATOL = 2e-3, 5e-3, 1e-4
RUNS = ["pod2_model2", "pod1_model2"]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Start the 8 ranks, compute the JAX side meanwhile, wait for the
    ranks; everything each test holds against."""
    in_dir = tmp_path_factory.mktemp("pipe_in")
    out_dir = tmp_path_factory.mktemp("pipe_out")
    cfg = jax_get_config(R.ARCH, reduced=True)
    model = JaxModel(cfg, JaxKnobs(**R.KNOBS))
    params = model.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(key, (8, 32), 0, cfg.vocab),
             "labels": jax.random.randint(key, (8, 32), 0, cfg.vocab)}
    np.savez(in_dir / "tree.npz", **R.flat(_np(params)))
    np.savez(in_dir / "batch.npz",
             **{k: np.asarray(v) for k, v in batch.items()})

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_pipeline_ranks.py"), str(in_dir),
         str(out_dir)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        rules = jax_make_rules("cp").with_mesh(jax_host_mesh(model=2, pod=2))

        def pipe(p, b):
            return jax_pipeline.pipeline_loss(model, rules, p, b,
                                              n_mb=R.N_MB)
        out = SimpleNamespace(out=out_dir)
        out.loss, out.grads = jax.jit(jax.value_and_grad(model.loss))(
            params, batch)
        out.pipe_loss, out.pipe_grads = jax.jit(jax.value_and_grad(pipe))(
            params, batch)
        out.loss, out.pipe_loss = float(out.loss), float(out.pipe_loss)
        out.grads, out.pipe_grads = _np(out.grads), _np(out.pipe_grads)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    return out


def load(path):
    """(loss, gradient tree in the JAX layout) a rank script saved."""
    with np.load(path) as z:
        grads = {}
        for k in z.files:
            if k != "loss":
                g, nm = k.split("__", 1)
                grads.setdefault(g, {})[nm] = z[k]
        return float(z["loss"]), grads


def grad_gap(got, want):
    """The largest |got - want| / (atol + rtol |want|) over every leaf (at
    most 1 within the tolerances)."""
    return max(float(np.max(np.abs(got[g][nm] - w) / (G_ATOL + G_RTOL
                                                       * np.abs(w))))
               for g, sub in want.items() for nm, w in sub.items())


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("against", ["model.loss", "pipeline_loss"])
def test_pipeline_loss_matches_jax(ref, run, against):
    loss, _ = load(ref.out / f"{run}.npz")
    want = ref.loss if against == "model.loss" else ref.pipe_loss
    print(f"\n[pipeline] {run} loss {loss:.8f} against JAX {against} "
          f"{want:.8f}: rel gap {abs(loss - want) / abs(want):.3e}")
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("against", ["model.loss", "pipeline_loss"])
def test_pipeline_grads_match_jax(ref, run, against):
    _, grads = load(ref.out / f"{run}.npz")
    want = ref.grads if against == "model.loss" else ref.pipe_grads
    assert set(grads) == set(want)
    print(f"\n[pipeline] {run} grads against JAX {against}: worst "
          f"|diff| / (atol + rtol |want|) {grad_gap(grads, want):.3e}")
    for g, sub in want.items():
        assert set(grads[g]) == set(sub)
        for nm, w in sub.items():
            np.testing.assert_allclose(grads[g][nm], w, rtol=G_RTOL,
                                       atol=G_ATOL, err_msg=f"{g}/{nm}")


def test_pod1_equals_model_loss_on_one_rank(ref):
    """(1, 1, 1) in a world-1 group: the loss and gradients of
    ``Model.loss`` averaged over the same 4 microbatches (the sums run in
    another order: 1e-6 of the loss, 1e-5 of each gradient's scale), and
    the same plain calls of every kernel."""
    loss, grads = load(ref.out / "world1_pipeline.npz")
    want_loss, want = load(ref.out / "world1_model_loss.npz")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for g, sub in want.items():
        for nm, w in sub.items():
            peak = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(grads[g][nm], w, rtol=1e-5,
                                       atol=1e-5 * peak, err_msg=f"{g}/{nm}")
    with np.load(ref.out / "world1_calls.npz") as z:
        calls = {k: int(z[k]) for k in z.files}
    for k in ("matmul", "rmsnorm", "flash_attention", "rmsnorm_bwd",
              "flash_attention_bwd"):
        assert calls[f"pipe__{k}"] == calls[f"ref__{k}"] > 0, k


@pytest.mark.parametrize("variant", ["cp", "dp", "tp", "cp_fsdp"])
def test_stage_rules_strip_pod_as_the_reference(variant):
    """The rules inside a stage: the reference's table with 'pod' stripped
    from every entry (its ``pipeline_loss``, ``:59-65``), on the mesh's
    other axes."""
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    got = pipeline.stage_rules(make_rules(variant).with_mesh(mesh))
    want = {}
    for k, v in jax_make_rules(variant).table.items():
        axes = (v,) if isinstance(v, str) else tuple(v or ())
        axes = tuple(a for a in axes if a != "pod")
        want[k] = axes if axes else None
    assert got.table == want
    assert tuple(got.mesh.mesh_dim_names) == ("data", "model")
    assert tuple(got.mesh.shape) == (2, 2)


def test_split_stages_as_the_reference():
    rng = np.random.default_rng(0)
    stacked = {"w": rng.standard_normal((6, 3, 4)).astype(np.float32),
               "b": rng.standard_normal((6, 5)).astype(np.float32)}
    want = jax_pipeline._split_stages(stacked, 3)
    import torch
    got = pipeline._split_stages({k: torch.from_numpy(v)
                                  for k, v in stacked.items()}, 3)
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
