"""The port's expert parallelism and compressed collectives against the JAX
package's, on the CPU: one gloo group of 8 ranks for the module
(``tests/torch_expert_parallel_ranks.py``, no JAX there), the JAX side on
``tests/conftest.py``'s 8 virtual devices.

- ``moe_ffn(dispatch="a2a")`` on reduced phi3.5-moe on a (2, 4) mesh under
  cp (all_to_all), tp (masked local experts summed) and dp (experts local)
  with the input of the reference's
  ``test_moe_dispatch_equivalence_all_regimes``: at capacity factor 8 and
  at 1 (cp and dp drop pairs, so the output is 0.095 from ``sort``'s)
  against JAX's ``a2a`` output within 2e-5, and the gradients of the
  router, the three expert stacks and x within 1e-5 x each tensor's
  largest magnitude of ``jax.grad`` of the same sum; a zero router (tied
  logits) routes as JAX's ``router_topk`` and keeps the pairs the
  reference's per-shard capacity keeps;
- ``sort`` and ``dense`` under cp rules against JAX's;
- the sharded train step (ga 2, 4 x 32, AdamW lr 1e-3 warmup 1) of reduced
  phi3.5-moe and deepseek-v2 under cp, dp, tp and cp_fsdp against the JAX
  sharded step (loss rtol 1e-5; parameters rtol 5e-4, atol 5e-5), and at
  capacity factor 8, where no pair drops, against the port's unsharded
  step;
- ``ring_allreduce_int8`` over 8 ranks, 777 wide: every row within 5% of
  the sum's scale and equal to the JAX ring's; ``ErrorFeedback``'s 20 steps
  against JAX's, step by step;
- ``launch/train.py --arch phi3.5-moe --reduced --model-axis 4`` on the 8
  ranks against the sharded step run in process on the same batches.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import moe as JM
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.parallel import compression as jax_compression
from repro.parallel import sharding as jax_sharding
from repro.train.optim import AdamWConfig as JaxAdamW
from repro.train.optim import adamw_init as jax_adamw_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model, ModelKnobs
from repro_torch.parallel.compression import ErrorFeedback
from repro_torch.parallel.sharding import MeshShape, make_rules
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.models.model import check_supported
from repro_torch.train.step import TrainConfig, make_train_step
from test_torch_moe import _reference_kept
from test_torch_sharded import assert_close, load
from test_torch_train import host_batch, numpy_tree, to_jax, to_torch
import torch_expert_parallel_ranks as R
import torch_sharded_ranks as SR

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
OUT_TOL, GRAD_TOL = 2e-5, 1e-5
LOSS_RTOL = 1e-5
RING_M = 777


def jax_moe_cfg(cf):
    cfg = jax_get_config(R.MOE_ARCH, reduced=True)
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))


def moe_inputs():
    """The reference's ``test_moe_dispatch_equivalence_all_regimes`` input
    (its PRNG draws, as numpy) and a cotangent for the output."""
    cfg = jax_moe_cfg(8.0)
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    out = {"router": jax.random.normal(ks[0], (D, E)) * 0.1,
           "w_gate": jax.random.normal(ks[1], (E, D, F)) * 0.05,
           "w_up": jax.random.normal(ks[2], (E, D, F)) * 0.05,
           "w_down": jax.random.normal(ks[3], (E, F, D)) * 0.05,
           "x": jax.random.normal(ks[4], (8, 16, D))}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out["g"] = np.random.default_rng(3).standard_normal(
        out["x"].shape).astype(np.float32)
    return out


def jax_moe(inp, cf, dispatch, variant=None, zero=False):
    """(y, {name: gradient}) of sum(moe_ffn(p, x) * g) in JAX, under the
    variant's rules on (2, 4) (None: no rules)."""
    cfg = jax_moe_cfg(cf)
    p = {k: jnp.asarray(inp[k]) for k in R.MOE_WEIGHTS}
    if zero:
        p["router"] = jnp.zeros_like(p["router"])
    g = jnp.asarray(inp["g"])

    def f(p, x):
        y = JM.moe_ffn(p, x, cfg, dispatch=dispatch)
        return jnp.sum(y * g), y
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    rules = None if variant is None else jax_sharding.make_rules(
        variant).with_mesh(jax_host_mesh(model=4))
    with jax_sharding.axis_rules(rules):
        (_, y), (gp, gx) = fn(p, jnp.asarray(inp["x"]))
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


def jax_ring(x):
    mesh = compat.make_mesh((R.WORLD,), ("data",),
                            axis_types=(compat.AxisType.Auto,))
    xs = jax.device_put(x, JaxNamedSharding(mesh, JaxP("data")))
    return np.asarray(jax.jit(lambda a: jax_compression.ring_allreduce_int8(
        a, mesh, "data"))(xs))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 ranks, compute the JAX side meanwhile, wait for the
    ranks; everything each test holds against."""
    in_dir = tmp_path_factory.mktemp("ep_in")
    out_dir = tmp_path_factory.mktemp("ep_out")
    inp = moe_inputs()
    np.savez(in_dir / "moe.npz", **inp)
    for arch in R.ARCHS:
        np.savez(in_dir / f"tree_{arch}.npz", **SR.flat(numpy_tree(arch)))
    batch = host_batch(R.MOE_ARCH, 0, 4, 32)
    np.savez(in_dir / "batches.npz", **batch)
    x_ring = np.random.default_rng(0).standard_normal(
        (R.WORLD, RING_M)).astype(np.float32)
    np.savez(in_dir / "ring.npz", x=x_ring)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_expert_parallel_ranks.py"),
         str(in_dir), str(out_dir)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        ref = SimpleNamespace(inp=inp, out=out_dir, moe={}, steps={},
                              ring_in=x_ring)
        for case, cf, zero in R.MOE_CASES:
            for v in R.REGIMES:
                ref.moe[case, v] = jax_moe(inp, cf, "a2a", v, zero)
        ref.moe["zero", "sort"] = jax_moe(inp, 1.0, "sort", zero=True)
        ref.moe["cf1", "sort"] = jax_moe(inp, 1.0, "sort")
        for d in ("sort", "dense"):
            ref.moe[d, "cp"] = jax_moe(inp, 1.0, d, "cp")
        for arch in R.ARCHS:
            for v in R.VARIANTS:
                ref.steps[f"{arch} {v}"] = jax_step(arch, v, batch)
        ref.ring = jax_ring(x_ring)
        # the port's unsharded step at capacity factor 8
        cfg = replace(get_config(R.MOE_ARCH, reduced=True), moe=replace(
            get_config(R.MOE_ARCH, reduced=True).moe, capacity_factor=8.0))
        model = Model(cfg, ModelKnobs(**SR.KNOBS), device="cpu")
        params = params_from_jax(numpy_tree(R.MOE_ARCH), cfg, "cpu")
        p, _, m = make_train_step(model, TrainConfig(
            grad_accum=2, optimizer=AdamWConfig(**SR.OPT)))(
                params, adamw_init(params), to_torch(batch))
        ref.port_cf8 = (params_to_jax(p, cfg), float(m["loss"]))
        proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    with np.load(out_dir / "moe.npz") as z:
        ref.got = {k: z[k] for k in z.files}
    return ref


def _assert_moe(got, key, want, out_tol=OUT_TOL):
    y, grads = want
    np.testing.assert_allclose(got[f"{key} y"], y, rtol=out_tol,
                               atol=out_tol)
    for name, w in grads.items():
        peak = float(np.abs(w).max())
        np.testing.assert_allclose(got[f"{key} d{name}"], w, rtol=0,
                                   atol=GRAD_TOL * peak, err_msg=name)


@pytest.mark.parametrize("regime", R.REGIMES)
@pytest.mark.parametrize("case", [c[0] for c in R.MOE_CASES])
def test_a2a_matches_jax(ranks, case, regime):
    """The output within 2e-5 of JAX's ``a2a`` and every gradient within
    1e-5 x its scale of ``jax.grad``'s."""
    _assert_moe(ranks.got, f"{case} {regime}", ranks.moe[case, regime])


def test_capacity_drops_stay(ranks):
    """At capacity factor 1 the per-shard capacity drops pairs under cp and
    dp, whose output stays 0.095 from ``sort``'s (JAX's and the port's
    alike), and none under tp."""
    sort_y = ranks.moe["cf1", "sort"][0]
    dist = {v: float(np.abs(ranks.got[f"cf1 {v} y"] - sort_y).max())
            for v in R.REGIMES}
    want = {v: float(np.abs(ranks.moe["cf1", v][0] - sort_y).max())
            for v in R.REGIMES}
    assert dist["cp"] > 0.09 and dist["dp"] > 0.09, dist
    assert dist["tp"] < OUT_TOL, dist
    np.testing.assert_allclose(list(dist.values()), list(want.values()),
                               atol=OUT_TOL)


@pytest.mark.parametrize("regime", R.REGIMES)
def test_zero_router_routes_as_jax(ranks, regime):
    """Tied logits: every rank's tokens go to JAX's ``router_topk`` experts
    (0 and 1, the lower index first), the kept pairs are the reference's
    per-shard capacity rule's, and JAX's output is zero exactly on the
    tokens with no kept pair."""
    cfg = jax_moe_cfg(1.0)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T = 8 * 16
    want_idx = np.asarray(JM.router_topk(jnp.zeros((T, E)), k)[1])
    with np.load(ranks.out / "routes.npz") as z:
        shards = [(tuple(z[f"{regime}__{r}__coord"]), z[f"{regime}__{r}__idx"],
                   z[f"{regime}__{r}__kept"]) for r in range(R.WORLD)]
    kept = np.zeros((T, k), bool)
    for (d, m), idx, kp in shards:
        n = idx.shape[0]
        if regime == "tp":
            # tokens by data coordinate, each pair computed on one rank
            rows = slice(d * n, (d + 1) * n)
            lo = m * (E // 4)
            local = (idx >= lo) & (idx < lo + E // 4)
            cap = moe._capacity(n, k, E // 4, 1.0)
            ref = _reference_kept(np.where(local, idx - lo, E // 4), E // 4 + 1, cap)
            np.testing.assert_array_equal(kp, ref & local)
            kept[rows] |= kp
        else:
            rows = slice((4 * d + m) * n, (4 * d + m + 1) * n)
            np.testing.assert_array_equal(
                kp, _reference_kept(idx, E, moe._capacity(n, k, E, 1.0)))
            kept[rows] = kp
        np.testing.assert_array_equal(idx, want_idx[rows])
    y = ranks.moe["zero", regime][0].reshape(T, -1)
    none = ~kept.any(axis=1)
    assert (regime == "tp") == (not none.any())
    assert np.all(y[none] == 0) and np.all(np.abs(y[~none]).max(axis=1) > 0)
    # sort's one capacity keeps every pair here
    from_sort = float(np.abs(y - ranks.moe["zero", "sort"][0].reshape(
        T, -1)).max())
    assert from_sort < OUT_TOL if regime == "tp" else from_sort > 0.01


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_global_dispatch_under_cp_matches_jax(ranks, dispatch):
    _assert_moe(ranks.got, f"{dispatch} cp", ranks.moe[dispatch, "cp"])


@pytest.mark.parametrize("variant", R.VARIANTS)
@pytest.mark.parametrize("arch", R.ARCHS)
def test_sharded_step_matches_jax(ranks, arch, variant):
    losses = json.loads((ranks.out / "steps.json").read_text())
    p, loss = ranks.steps[f"{arch} {variant}"]
    np.testing.assert_allclose(losses[f"{arch} {variant}"], loss,
                               rtol=LOSS_RTOL)
    assert_close(load(ranks.out / f"step_{arch} {variant}.npz"), p)


def test_sharded_step_without_drops_matches_unsharded_port(ranks):
    """At capacity factor 8 no pair drops in either dispatch: the cp step
    lands on the port's unsharded (``sort``) step."""
    losses = json.loads((ranks.out / "steps.json").read_text())
    p, loss = ranks.port_cf8
    np.testing.assert_allclose(losses[f"{R.MOE_ARCH} cp cf8"], loss,
                               rtol=LOSS_RTOL)
    assert_close(load(ranks.out / f"step_{R.MOE_ARCH} cp cf8.npz"), p)


def test_ring_allreduce_int8(ranks):
    """Every row within 5% of the sum's scale (the reference's test) and
    equal to the JAX ring's row."""
    with np.load(ranks.out / "ring.npz") as z:
        rows = np.stack([z[f"row{r}"] for r in range(R.WORLD)])
    want = ranks.ring_in.sum(0)
    scale = np.abs(want).max()
    for r in range(R.WORLD):
        assert np.abs(rows[r] - want).max() / scale < 0.05
    np.testing.assert_allclose(rows, ranks.ring, rtol=0, atol=1e-6 * scale)


def test_error_feedback_matches_jax():
    """The reference's ``test_error_feedback_reduces_bias`` (20 steps of
    the same gradient: the compressed sum within 5% of the true sum), each
    step's compressed value and residual equal to JAX's; a tree of a bf16
    gradient keeps its dtype and f32 residuals."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal(4096).astype(np.float32)
    gt, gj = torch.from_numpy(g), jnp.asarray(g)
    rt, rj = ErrorFeedback.init(gt), jax_compression.ErrorFeedback.init(gj)
    acc = np.zeros(4096)
    for _ in range(20):
        ct, rt = ErrorFeedback.apply(gt, rt)
        cj, rj = jax_compression.ErrorFeedback.apply(gj, rj)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        acc += ct.numpy()
    assert np.abs(acc - 20 * g).max() < 0.05 * np.abs(20 * g).max()
    tree = {"a": {"w": gt.to(torch.bfloat16).reshape(64, 64)}, "b": gt[:7]}
    c, e = ErrorFeedback.apply(tree, ErrorFeedback.init(tree))
    assert c["a"]["w"].dtype == torch.bfloat16 and c["b"].shape == (7,)
    assert e["a"]["w"].dtype == torch.float32


def test_cli_model_axis_moe_matches_in_process_step(ranks):
    """``launch/train.py --arch phi3.5-moe --reduced --model-axis 4`` on
    the 8 ranks: its losses are the in-process sharded step's on the same
    weights and batches."""
    got = json.loads((ranks.out / "cli.json").read_text())
    assert len(got["cli"]) == 2
    np.testing.assert_allclose(got["cli"], got["in_process"],
                               rtol=LOSS_RTOL)


def test_capacity_matches_jax():
    for t in (1, 7, 16, 64, 100):
        for k, n, cf in ((2, 4, 1.0), (2, 4, 1.25), (6, 160, 1.25),
                         (2, 1, 8.0)):
            assert moe._capacity(t, k, n, cf) == JM._capacity(t, k, n, cf)
    for v in (None, "data", ("data", "model")):
        assert moe._axes_tuple(v) == JM._axes_tuple(v)


@pytest.mark.parametrize("arch", ["phi3.5-moe", "deepseek-v2",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_sharded_step_admits_moe_and_mla_only(arch):
    """The MoE and MLA families take the sharded step, and since the SSM
    scans run under rules (``tests/test_torch_sharded_ssm.py``) so do
    jamba and xlstm-125m: the sharded step builds for each; a kind the
    model does not run is refused."""
    cfg = get_config(arch, reduced=True)
    make_train_step(Model(cfg, device="cpu"), rules=make_rules(
        "cp").with_mesh(MeshShape(("data", "model"), (2, 4))))
    with pytest.raises(NotImplementedError, match="mixers"):
        check_supported(SimpleNamespace(
            name=cfg.name, pattern=("conv",), ffn_pattern=cfg.ffn_pattern))
