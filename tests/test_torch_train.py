"""The port's training path against the JAX package's, on the CPU.

- ``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
  JAX ``Model.loss`` on one reduced configuration of each family (dense,
  MoE, MLA, xLSTM, jamba, musicgen's codebooks, internvl2's patch prefix),
  the port under remat none, full and dots: the loss within rtol 1e-4,
  every gradient within atol 1e-5 x its largest magnitude (rtol 1e-4).
  The JAX side runs once a family, at its default remat: a remat policy
  changes what the reference saves, not what it computes, and one compile
  a family keeps this file's time;
- the remat's cost structure, counted in matmul calls: full recomputes
  every product of the periods, dots only those with a batch dimension (a
  MoE layer's 3E expert products; none for a dense layer); serving runs
  no checkpoint and records no graph under any remat;
- ``simulate_int8_roundtrip``, ``synthetic_batch`` (all ten reduced
  configurations at steps 0 and 7) and ``MemmapCorpus`` bit for bit.

The JAX trees are drawn with numpy in the JAX layout from the JAX
package's own spec (``_spec_tree``; no JAX init to compile), the norms and
zero biases drawn too, the MoE experts' down-projections scaled by 0.1
(the reference's MoE reads the un-normalized residual,
``tests/test_torch_ssm.py``).  The train step and the checkpoint:
``tests/test_torch_checkpoint.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import Shape as JaxShape
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.models.model import _spec_tree
from repro.parallel import compression as jax_compression
from repro.train import data as jax_data
from repro_torch.configs import ARCHS, Shape, get_config
from repro_torch.kernels import ops
from repro_torch.models import remat as R
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model, ModelKnobs
from repro_torch.parallel import compression
from repro_torch.train import data
from repro_torch.train.step import loss_and_grads

FAMILIES = ("smollm-135m", "phi3.5-moe", "deepseek-v2", "xlstm-125m",
            "jamba-v0.1-52b", "musicgen-large", "internvl2-2b")
REMATS = ("none", "full", "dots")
BATCH, SEQ = 2, 16
KNOBS = dict(kv_chunk=16, ssm_chunk=8, moe_dispatch="sort")
RTOL, ATOL = 1e-4, 1e-5


def numpy_tree(arch, seed=0):
    """A JAX-layout parameter tree of the reduced ``arch``, drawn with
    numpy: weights N(0, 1/fan_in), embeddings N(0, 0.02^2), norms and the
    init's zero biases N(0, 0.01), Mamba's ``a_log``, ``dt_b`` and ``d``
    as the JAX init; the MoE experts' down-projections scaled by 0.1."""
    rng = np.random.default_rng(seed)
    tree = {}
    for g, sub in sorted(_spec_tree(jax_get_config(arch,
                                                   reduced=True)).items()):
        for nm, (shape, _, fan) in sorted(sub.items()):
            if nm.endswith("a_log"):
                a = np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)),
                                    shape)
            elif nm.endswith("dt_b"):
                a = np.full(shape, math.log(math.expm1(0.01)))
            elif nm.endswith("mix_d"):
                a = np.ones(shape)
            elif nm.endswith(("ln", "b_if", "_b")) or fan == 0.0:
                a = rng.standard_normal(shape) * 0.1
            else:
                std = 0.02 if fan == -1 else 1.0 / math.sqrt(max(fan, 1))
                a = rng.standard_normal(shape) * std
                if nm == "ffn_w_down" and "ffn_router" in sub:
                    a = a * 0.1
            tree.setdefault(g, {})[nm] = np.ascontiguousarray(a, np.float32)
    return tree


def host_batch(arch, step=0, batch=BATCH, seq=SEQ):
    """The JAX package's synthetic batch (a patch prefix counts in seq)."""
    cfg = jax_get_config(arch, reduced=True)
    return jax_data.synthetic_batch(
        cfg, JaxShape("t", seq + cfg.n_patches, batch, "train"), step)


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    """Every leaf of the port's tree (taken to the JAX layout by the
    caller) within atol x its largest magnitude."""
    for g, sub in want.items():
        for nm, w in sub.items():
            w = np.asarray(w)
            peak = float(np.abs(w).max())
            np.testing.assert_allclose(got[g][nm], w, rtol=rtol,
                                       atol=atol * peak, err_msg=f"{g}/{nm}")


_JAX_REFS = {}


def jax_reference(arch):
    """(tree, batch, loss, grads) of the JAX ``Model.loss`` on ``arch``,
    computed once."""
    if arch not in _JAX_REFS:
        tree, b = numpy_tree(arch), host_batch(arch)
        jm = JaxModel(jax_get_config(arch, reduced=True), JaxKnobs(**KNOBS))
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
            jax.tree.map(jnp.asarray, tree), to_jax(b))
        _JAX_REFS[arch] = (tree, b, float(loss),
                           jax.tree.map(np.asarray, grads))
    return _JAX_REFS[arch]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, remat):
    tree, b, jloss, jgrads = jax_reference(arch)
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, ModelKnobs(remat=remat, **KNOBS), device="cpu")
    loss, grads = loss_and_grads(model, params_from_jax(tree, cfg, "cpu"),
                                 to_torch(b))
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    assert_tree_close(params_to_jax(grads, cfg), jgrads)


def matmul_calls(model, params, b):
    n = ops.plain_calls["matmul"]
    loss_and_grads(model, params, to_torch(b))
    return ops.plain_calls["matmul"] - n


@pytest.mark.parametrize("arch", ("smollm-135m", "phi3.5-moe"))
def test_remat_recomputes_what_the_reference_recomputes(arch):
    """Matmul calls of one loss-and-gradient: remat none makes 3 a product
    (forward, dA, dB); full adds every product of the periods once more
    (each layer's 7 dense projections, or q/k/v/o, the router and 3E
    expert products); dots adds only the expert products, which have a
    batch dimension (``ecd,edf->ecf``), and none for a dense layer."""
    cfg = get_config(arch, reduced=True)
    params = params_from_jax(numpy_tree(arch), cfg, "cpu")
    b = host_batch(arch)
    calls = {r: matmul_calls(Model(cfg, ModelKnobs(remat=r, **KNOBS),
                                   device="cpu"), params, b)
             for r in REMATS}
    moe = cfg.ffn_pattern[0] == "moe"
    batched = 3 * cfg.moe.n_experts if moe else 0       # a layer
    per_layer = (5 if moe else 7) + batched
    assert calls["none"] == 3 * (cfg.n_layers * per_layer + 1)
    assert calls["full"] - calls["none"] == cfg.n_layers * per_layer
    assert calls["dots"] - calls["none"] == cfg.n_layers * batched


def test_dots_hands_back_the_kept_outputs():
    """Under dots the recompute launches no projection: each takes the
    first forward's output back, and a period's kept outputs are exactly
    its projections (7 a dense layer)."""
    cfg = get_config("smollm-135m", reduced=True)
    params = params_from_jax(numpy_tree("smollm-135m"), cfg, "cpu")
    stashes = []
    real = R._Stash

    class Counting(real):
        def __init__(self):
            super().__init__()
            stashes.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "_Stash", Counting)
        model = Model(cfg, ModelKnobs(remat="dots", **KNOBS), device="cpu")
        loss_and_grads(model, params, to_torch(host_batch("smollm-135m")))
    assert len(stashes) == cfg.n_layers
    assert [len(s.outs) for s in stashes] == [7] * cfg.n_layers
    assert [s.next for s in stashes] == [7] * cfg.n_layers


@pytest.mark.parametrize("remat", REMATS)
def test_serving_runs_no_checkpoint(remat):
    """Prefill, decode and a forward without grad run no checkpoint and
    record no graph, under every remat."""
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    model = Model(cfg, ModelKnobs(remat=remat, **KNOBS), device="cpu")
    params = params_from_jax(numpy_tree("jamba-v0.1-52b"), cfg, "cpu")
    calls = []
    real = R.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "checkpoint", lambda *a, **k: calls.append(1)
                   or real(*a, **k))
        tok = torch.from_numpy(np.array(host_batch("jamba-v0.1-52b")
                                        ["tokens"]))
        logits, cache, t = model.prefill(params, {"tokens": tok}, 32)
        out, _ = model.decode_step(params, cache, t, {"tokens": tok[:, :1]})
        assert logits.grad_fn is None and out.grad_fn is None
        grad_params = {g: {k: v.requires_grad_(True) for k, v in sub.items()}
                       for g, sub in params.items()}
        with torch.no_grad():
            assert model.forward(grad_params, {"tokens": tok}).grad_fn is None
        assert not calls
        model.loss(grad_params, to_torch(host_batch("jamba-v0.1-52b")))
    assert len(calls) == (0 if remat == "none" else cfg.n_periods)


def test_remat_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        R.run("some", lambda x: x, torch.ones(2, requires_grad=True))


# ---------------------------------------------------------------------------
# bit-equal pieces: the int8 round trip, the data
# ---------------------------------------------------------------------------

def int8_inputs():
    rng = np.random.default_rng(3)
    return {"drawn": rng.standard_normal((4, 300)).astype(np.float32),
            "wide range": (rng.standard_normal(1024)
                           * np.exp(rng.uniform(-20, 20, 1024))
                           ).astype(np.float32),
            "zero block": np.concatenate([
                np.zeros(256, np.float32),
                rng.standard_normal(256).astype(np.float32)]),
            "padded tail": rng.standard_normal((3, 7, 5)).astype(np.float32),
            "halves": (np.arange(-512, 512) / 2).astype(np.float32),
            "scalar": np.full((), 1.5, np.float32)}


@pytest.mark.parametrize("name", sorted(int8_inputs()))
def test_int8_roundtrip_bit_equal_to_jax(name):
    x = int8_inputs()[name]
    want = np.asarray(jax_compression.simulate_int8_roundtrip(
        jnp.asarray(x)))
    got = compression.simulate_int8_roundtrip(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    q, s, pad = compression.quantize_int8(torch.from_numpy(x))
    jq, js, jpad = jax_compression.quantize_int8(jnp.asarray(x))
    assert pad == jpad
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("step", (0, 7))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_synthetic_batch_bit_equal_to_jax(arch, step):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                              reduced=True)
    seq = 16 + cfg.n_patches
    dc = data.DataConfig(seed=5)
    got = data.synthetic_batch(cfg, Shape("t", seq, 3, "train"), step, dc)
    want = jax_data.synthetic_batch(jcfg, JaxShape("t", seq, 3, "train"),
                                    step, jax_data.DataConfig(seed=5))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_memmap_corpus_and_iterator_equal_jax(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    cfg = get_config("smollm-135m", reduced=True)
    jcfg = jax_get_config("smollm-135m", reduced=True)
    got = data.MemmapCorpus(str(path), cfg.vocab).batch(4, 32, 3, seed=2)
    want = jax_data.MemmapCorpus(str(path), jcfg.vocab).batch(4, 32, 3,
                                                              seed=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    it = data.batch_iterator(cfg, Shape("t", 32, 4, "train"),
                             data.DataConfig(seed=2, corpus_path=str(path)),
                             start_step=3)
    jit_ = jax_data.batch_iterator(
        jcfg, JaxShape("t", 32, 4, "train"),
        jax_data.DataConfig(seed=2, corpus_path=str(path)), start_step=3)
    for _ in range(2):
        a, b = next(it), next(jit_)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
