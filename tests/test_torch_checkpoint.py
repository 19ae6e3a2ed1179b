"""The port's train step, checkpoint and training launcher, on the CPU.

- ``make_train_step`` against the JAX step: three steps of reduced
  smollm-135m at grad_accum 1 and 2 (losses, ``grad_norm``, ``lr``,
  parameters), one step with ``grad_compression="int8"``, the bf16
  accumulation carry;
- the port's counterparts of ``tests/test_checkpoint.py``: a bitwise
  restart, retention and ``latest_step``, no partial checkpoint left;
- across packages (the JAX on-disk format): a JAX checkpoint saved after 3
  steps restores in the port, and 3 more port steps give the JAX 6-step
  parameters; a port checkpoint restores through
  ``repro.train.checkpoint.restore`` with the JAX ``like`` tree, bit for
  bit, its manifest the one the JAX ``save`` writes;
- ``params_to_jax`` round-trips every configuration bit for bit;
- ``repro_torch.launch.train`` on the CPU: a rerun after the last
  checkpoint is lost resumes and ends bit for bit where the straight run
  did; ``--model-axis 1`` in a group of one rank gives the same bits, and a
  model axis that does not divide the world is refused (the 8-rank runs:
  ``tests/test_torch_sharded.py``).
"""

import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.train import checkpoint as jax_ckpt
from repro.train.optim import AdamWConfig as JaxAdamW
from repro.train.optim import adamw_init as jax_adamw_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model, ModelKnobs, spec_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.step import TrainConfig, make_train_step
from test_torch_train import (KNOBS, RTOL, host_batch, numpy_tree, to_jax,
                              to_torch)

# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def run_both(grad_accum, compression_="none", steps=3, arch="smollm-135m"):
    """``steps`` steps of the JAX and the port's train step from one tree
    on the synthetic stream (batch 4 x seq 16): (JAX params, metrics per
    step; port params, metrics per step)."""
    tree = numpy_tree(arch)
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                               reduced=True)
    opt = dict(lr=STEP_LR, warmup=2, decay_steps=steps)
    jstep = jax.jit(jax_make_train_step(
        JaxModel(jcfg, JaxKnobs(**KNOBS)), None,
        JaxTrainConfig(grad_accum=grad_accum, optimizer=JaxAdamW(**opt),
                       grad_compression=compression_)))
    tstep = make_train_step(
        Model(cfg, ModelKnobs(**KNOBS), device="cpu"),
        TrainConfig(grad_accum=grad_accum, optimizer=AdamWConfig(**opt),
                    grad_compression=compression_))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jax_adamw_init(jp)
    tp = params_from_jax(tree, cfg, "cpu")
    to = adamw_init(tp)
    jm, tm = [], []
    for i in range(steps):
        b = host_batch(arch, step=i, batch=4)
        jp, jo, m = jstep(jp, jo, to_jax(b))
        jm.append({k: float(v) for k, v in m.items()})
        tp, to, m = tstep(tp, to, to_torch(b))
        tm.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, jp), jm, params_to_jax(tp, cfg), tm


# AdamW moves every element by about lr whatever the size of its gradient
# (m / sqrt(v)), so where a gradient is at the rounding level of the two
# packages' sums (an embedding row that no token of the batch takes, reached
# only through the tied head) the parameters differ by a share of lr: they
# are held within atol lr / 100 beside rtol 1e-4 (a missing or wrong term
# of the update moves elements by ~lr)
STEP_LR = 1e-2
PARAM_ATOL = STEP_LR / 100


def assert_params_close(got, want):
    for g, sub in want.items():
        for nm, w in sub.items():
            np.testing.assert_allclose(got[g][nm], w, rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=f"{g}/{nm}")


@pytest.mark.parametrize("grad_accum", (1, 2))
def test_train_step_matches_jax(grad_accum):
    jp, jm, tp, tm = run_both(grad_accum)
    for j, t in zip(jm, tm):
        assert set(t) == set(j) == {"loss", "grad_norm", "lr"}
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    assert tm[0]["loss"] != tm[-1]["loss"]      # the steps moved
    assert_params_close(tp, jp)


def test_train_step_int8_matches_jax():
    jp, jm, tp, tm = run_both(2, "int8", steps=1)
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=RTOL)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=RTOL)
    assert_params_close(tp, jp)


def test_train_step_refuses_what_it_cannot_run():
    model = Model(get_config("smollm-135m", reduced=True), device="cpu")
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, TrainConfig(grad_compression="fp8"))
    step = make_train_step(model, TrainConfig(grad_accum=3))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), to_torch(host_batch("smollm-135m",
                                                             batch=4)))


def test_accum_dtype_sums_in_its_dtype():
    """bf16 accumulation: the carry is bf16, the update's input too."""
    model = Model(get_config("smollm-135m", reduced=True), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    step = make_train_step(model, TrainConfig(grad_accum=2,
                                              accum_dtype=torch.bfloat16))
    import repro_torch.train.step as step_mod
    real = step_mod.adamw_update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "adamw_update",
                   lambda cfg, p, g, s: seen.append(g) or real(cfg, p, g, s))
        _, _, m = step(params, adamw_init(params),
                       to_torch(host_batch("smollm-135m", batch=4)))
    assert seen[0]["embed"]["tok"].dtype == torch.bfloat16
    assert math.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------

ARCH = "smollm-135m"
CKPT_OPT = dict(lr=1e-3, warmup=1)


def port_setup():
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
    params = params_from_jax(numpy_tree(ARCH), cfg, "cpu")
    step = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**CKPT_OPT)))
    return cfg, params, adamw_init(params), step


def run_port(step, params, opt, a, b):
    loss = None
    for i in range(a, b):
        params, opt, m = step(params, opt, to_torch(host_batch(ARCH, i, 4)))
        loss = float(m["loss"])
    return params, opt, loss


def meta_like(cfg):
    params = {g: {nm: torch.empty(shape, device="meta")
                  for nm, (shape, _) in sub.items()}
              for g, sub in spec_tree(cfg).items()}
    return {"params": params, "opt": adamw_init(params)}


def assert_trees_equal(a, b):
    """The same paths, and at each the same dtype, shape and bits."""
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def test_restart_bitwise_identical(tmp_path):
    cfg, params, opt, step = port_setup()
    d = str(tmp_path / "ck")
    p6, o6, l6 = run_port(step, params, opt, 0, 6)
    p3, o3, _ = run_port(step, params, opt, 0, 3)
    ckpt.save(d, 3, {"params": p3, "opt": o3}, cfg=cfg)
    tree, man = ckpt.restore(d, 3, meta_like(cfg), cfg=cfg, device="cpu")
    assert man["step"] == 3
    assert_trees_equal(tree, {"params": p3, "opt": o3})
    p6b, o6b, l6b = run_port(step, tree["params"], tree["opt"], 3, 6)
    assert l6 == l6b    # bitwise-identical continuation
    assert_trees_equal({"params": p6b, "opt": o6b},
                       {"params": p6, "opt": o6})


def test_retention_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_atomic_no_partial_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, {"x": torch.ones(8)})
    assert not [e for e in os.listdir(d) if e.startswith(".tmp")]
    tree, _ = ckpt.restore(d, 7, {"x": torch.empty(8)})
    assert torch.equal(tree["x"], torch.ones(8))
    # a write that fails leaves neither a tmp dir nor the step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt.np, "savez", lambda *a, **k: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            ckpt.save(d, 8, {"x": torch.ones(8)})
    assert sorted(os.listdir(d)) == ["step_0000000007"]


def test_restore_checks_every_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"x": torch.ones(8)})
    with pytest.raises(ValueError, match="checkpoint leaf x"):
        ckpt.restore(d, 1, {"x": torch.empty(9)})
    cfg, params, opt, _ = port_setup()
    ckpt.save(d, 2, {"params": params, "opt": opt}, cfg=cfg)
    like = meta_like(cfg)
    like["opt"]["v"]["final"]["ln"] = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="opt/v/final/ln"):
        ckpt.restore(d, 2, like, cfg=cfg, device="cpu")


def jax_setup():
    cfg = jax_get_config(ARCH, reduced=True)
    step = jax.jit(jax_make_train_step(
        JaxModel(cfg, JaxKnobs(**KNOBS)), None,
        JaxTrainConfig(optimizer=JaxAdamW(**CKPT_OPT))))
    params = jax.tree.map(jnp.asarray, numpy_tree(ARCH))
    return step, params, jax_adamw_init(params)


def run_jax(step, params, opt, a, b):
    for i in range(a, b):
        params, opt, m = step(params, opt, to_jax(host_batch(ARCH, i, 4)))
    return params, opt


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """3 JAX steps, saved by the JAX package; restored in the port, 3 port
    steps land on the JAX 6-step parameters (the train step's
    tolerance)."""
    jstep, jp, jo = jax_setup()
    jp3, jo3 = run_jax(jstep, jp, jo, 0, 3)
    jp6, _ = run_jax(jstep, jp3, jo3, 3, 6)
    d = str(tmp_path / "ck")
    jax_ckpt.save(d, 3, {"params": jp3, "opt": jo3})
    cfg, _, _, step = port_setup()
    tree, man = ckpt.restore(d, 3, meta_like(cfg), cfg=cfg, device="cpu")
    assert man["step"] == 3 and int(tree["opt"]["step"]) == 3
    np.testing.assert_array_equal(
        params_to_jax(tree["opt"]["m"], cfg)["pos0"]["mix_wq"],
        np.asarray(jo3["m"]["pos0"]["mix_wq"]))
    p6, _, _ = run_port(step, tree["params"], tree["opt"], 3, 6)
    assert_params_close(params_to_jax(p6, cfg),
                        jax.tree.map(np.asarray, jp6))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port checkpoint read by ``repro.train.checkpoint.restore`` with
    the JAX ``like`` tree: the same bits, in the JAX layout, and the
    manifest the JAX ``save`` writes for that tree."""
    cfg, params, opt, step = port_setup()
    p2, o2, _ = run_port(step, params, opt, 0, 2)
    d, dj = str(tmp_path / "ck"), str(tmp_path / "ckj")
    ckpt.save(d, 2, {"params": p2, "opt": o2}, cfg=cfg, extra={"a": 1})
    want = {"params": params_to_jax(p2, cfg),
            "opt": {"m": params_to_jax(o2["m"], cfg),
                    "v": params_to_jax(o2["v"], cfg),
                    "step": o2["step"].numpy()}}
    like = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, want))
    got, man = jax_ckpt.restore(d, 2, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    jax_ckpt.save(dj, 2, want, extra={"a": 1})
    with open(os.path.join(dj, "step_0000000002", "manifest.json")) as f:
        assert man == json.load(f)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_to_jax_round_trips(arch):
    cfg = get_config(arch, reduced=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    tree = params_to_jax(params, cfg)
    spec = jax.eval_shape(lambda: jax.tree.map(
        jnp.asarray, numpy_tree(arch)))
    assert jax.tree.map(lambda a: a.shape, tree) == \
        jax.tree.map(lambda a: a.shape, spec)
    assert_trees_equal(params_from_jax(tree, cfg, "cpu"), params)
    g = next(iter(params))
    bad = dict(params, **{g: {k: v[..., :1] for k, v in params[g].items()}})
    with pytest.raises(ValueError, match="shape"):
        params_to_jax(bad, cfg)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def cli(ckpt_dir, *extra):
    return train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "6", "--batch", "4", "--seq", "16",
                           "--grad-accum", "2", "--ckpt-every", "3",
                           "--log-every", "1", "--ckpt-dir", ckpt_dir,
                           *extra])


def test_cli_resumes_bit_for_bit(tmp_path, capsys):
    """A straight run of 6 steps; then the same command after its last
    checkpoint is deleted (as if killed after step 3's save) resumes from
    step 3 and ends on the straight run's losses and parameters."""
    d = str(tmp_path / "ck")
    straight = cli(d)
    assert straight["start"] == 0 and len(straight["history"]) == 6
    assert ckpt.all_steps(d) == [3, 6]
    shutil.rmtree(os.path.join(d, "step_0000000006"))
    capsys.readouterr()
    resumed = cli(d)
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 6 steps" in out
    assert resumed["start"] == 3
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"][3:]]
    assert_trees_equal({"p": resumed["params"], "o": resumed["opt"]},
                       {"p": straight["params"], "o": straight["opt"]})
    assert ckpt.all_steps(d) == [3, 6]


def test_cli_refuses_a_model_axis(capsys):
    """A model axis that does not divide the world (here one rank, the
    launcher's own group) is refused, and the group it made is gone."""
    with pytest.raises(SystemExit, match="does not divide the world of 1"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--model-axis", "2"])
    assert not torch.distributed.is_initialized()


def test_cli_model_axis_1_is_the_one_device_run(tmp_path):
    """``--model-axis 1`` under a group of one rank (gloo, made and
    destroyed by the launcher): the sharded step on a (1, 1) mesh gives
    the one-device run's losses, parameters and AdamW state bit for bit,
    and its checkpoints resume it."""
    one = cli(str(tmp_path / "a"))
    sharded = cli(str(tmp_path / "b"), "--model-axis", "1", "--variant",
                  "cp")
    assert not torch.distributed.is_initialized()
    assert [h["loss"] for h in sharded["history"]] == \
        [h["loss"] for h in one["history"]]
    assert_trees_equal({"p": sharded["params"], "o": sharded["opt"]},
                       {"p": one["params"], "o": one["opt"]})
    shutil.rmtree(tmp_path / "b" / "step_0000000006")
    resumed = cli(str(tmp_path / "b"), "--model-axis", "1")
    assert resumed["start"] == 3
    assert_trees_equal({"p": resumed["params"], "o": resumed["opt"]},
                       {"p": one["params"], "o": one["opt"]})


def test_cli_wants_the_card_by_default():
    argv = ["--arch", ARCH, "--reduced", "--steps", "0"]
    if torch.cuda.is_available():
        out = train_cli.main(argv)
        assert out["params"]["embed"]["tok"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(argv)
