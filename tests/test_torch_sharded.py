"""The port's multi-device half of training against the JAX package's, on
the CPU: one gloo group of 8 ranks for the module, the JAX side on
``tests/conftest.py``'s 8 virtual devices.

- the rules (in-process, no process group): ``make_rules``' four tables,
  ``with_mesh`` (dropping ``pod``), ``override`` and ``spec(dims=)`` equal
  the reference's on (2, 4), (8, 1) and (2, 2, 2) meshes, on drawn axes,
  dims and variants too; the reference's own dedup/fallback and property
  cases on the port's rules; specs become DTensor placements only with
  their tuples in mesh order;
- every parameter's spec for the ten reduced configurations under the four
  variants equals the reference ``param_shardings``' spec, through the
  3-D-to-2-D mapping of the attention and MLA projections; at full-width
  smollm-135m on a (1, 4) mesh the 9 heads do not shard (the 576 merged
  columns would);
- in the 8 ranks (``tests/torch_sharded_ranks.py``, no JAX there): each
  rank's local shards under cp on (2, 4) against the JAX array's shard at
  the same mesh coordinate; ``ops.matmul``, ``rmsnorm``, ``flash_attention``
  and ``layers.linear`` on sharded DTensors against whole tensors (forward
  and gradients within 1e-5 x scale), and the replicated-weight matmul
  wrong without its ``Partial`` gradient placement (flash: a sequence split
  evenly keeps the queries split, each rank at its offset, over one mesh
  dim or both; an uneven one is gathered); under cp every local flash
  call of the step gets the rank's S / 4 query rows at offset j S / 4 and
  the attention output stays ``Shard(1)``; the sharded train step
  (reduced smollm-135m, ga 2, 4 x 32, AdamW lr 1e-3 warmup 1) under cp,
  dp, tp and cp_fsdp against the JAX sharded step and the port's unsharded
  one (loss rtol 1e-5, parameters rtol 5e-4 / atol 5e-5; the global
  gradient norm; cp under remat "dots" and with the int8 round trip too),
  ga 1 against ga 4; the elastic restore from (8, 1) onto (2, 4) bit for bit; a sharded
  port checkpoint restored by JAX's ``restore`` onto its mesh, and a JAX
  one resumed in the port; ``launch/train.py --model-axis 4 --device cpu``
  against the one-device launcher, and its resume.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding as JaxNamedSharding

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models.model import Model as JaxModel
from repro.models.model import ModelKnobs as JaxKnobs
from repro.parallel import sharding as jax_sharding
from repro.train import checkpoint as jax_ckpt
from repro.train.optim import AdamWConfig as JaxAdamW
from repro.train.optim import adamw_init as jax_adamw_init
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import param_shardings as jax_param_shardings
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models import remat
from repro_torch.models.model import Model, ModelKnobs, spec_tree
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (RULE_VARIANTS, MeshShape,
                                           axis_rules, current_rules,
                                           make_rules, placements)
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.step import (TrainConfig, make_train_step,
                                    param_shardings)
from test_torch_train import host_batch, numpy_tree, to_jax, to_torch
import torch_sharded_ranks as R

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = {"(2, 4)": dict(model=4), "(8, 1)": dict(model=1),
          "(2, 2, 2)": dict(model=2, pod=2)}
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 5e-4, 5e-5
OP_TOL = 1e-5


def mesh_pair(name):
    """(JAX mesh, port MeshShape) of one of ``MESHES``."""
    jm = jax_host_mesh(**MESHES[name])
    return jm, MeshShape(tuple(jm.axis_names), tuple(jm.devices.shape))


def jax_rules(variant, jmesh):
    return jax_sharding.make_rules(variant).with_mesh(jmesh)


# ---------------------------------------------------------------------------
# the rules, in-process
# ---------------------------------------------------------------------------

SPEC_CASES = [
    (("batch", "seq", "embed"), (8, 32, 64)),
    (("batch", "seq", "vocab"), (4, 8, 12)),
    (("batch", None), (1, 8)),
    (("tokens", "embed"), (64, 16)),
    (("layers", "fsdp_embed", "heads_w", None), (2, 64, 4, 8)),
    (("layers", "heads_w", None, "fsdp_embed"), (2, 9, 64, 576)),
    (("expert", "fsdp_embed", "ffn"), (16, 64, 128)),
    (("exp_cap", "lora", "inner", "state"), (8, 6, 12, 16)),
    (("batch", "kv_seq", "kv_heads", None), (2, 16, 2, 8)),
]


@pytest.mark.parametrize("variant", RULE_VARIANTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_match_jax(mesh, variant):
    jm, pm = mesh_pair(mesh)
    jr, pr = jax_sharding.make_rules(variant), make_rules(variant)
    assert pr.name == jr.name and pr.table == jr.table
    jr, pr = jr.with_mesh(jm), pr.with_mesh(pm)
    assert pr.table == jr.table
    for axes, dims in SPEC_CASES:
        assert tuple(pr.spec(*axes, dims=dims)) == \
            tuple(jr.spec(*axes, dims=dims)), (axes, dims)
        assert tuple(pr.spec(*axes)) == tuple(jr.spec(*axes))
    jo, po = jr.override(batch="model", ffn=None), \
        pr.override(batch="model", ffn=None)
    assert po.table == jo.table
    for axes, dims in SPEC_CASES:
        assert tuple(po.spec(*axes, dims=dims)) == \
            tuple(jo.spec(*axes, dims=dims))
    assert all(a in pm.mesh_dim_names for a in pr.mesh_axes("batch"))


def test_rules_spec_dedup_and_fallback():
    """The reference's ``test_rules_spec_dedup_and_fallback`` on the port's
    rules."""
    rules = make_rules("cp").with_mesh(MeshShape(("data", "model"), (2, 4)))
    s = rules.spec("batch", "seq", "vocab", dims=(4, 8, 12))
    assert s[1] == "model" and (len(s) < 3 or s[2] is None)
    s2 = rules.spec("batch", None, dims=(1, 8))
    assert len(s2) == 0 or s2[0] is None
    assert all(ax in ("data", "model")
               for ax in (rules.mesh_axes("batch") or ()))


LOGICALS = ["batch", "seq", "ffn", "vocab", "embed", "tokens", "fsdp_embed",
            "expert", "heads_w", "lora", "exp_cap", None]


def test_rules_spec_properties_and_jax_agreement():
    """For drawn logical axes, dims, variants and meshes: the port's spec
    equals the reference's, never uses a mesh axis twice, only shards
    divisible dims, and becomes placements."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    pairs = {name: mesh_pair(name) for name in MESHES}

    @given(st.lists(st.sampled_from(LOGICALS), min_size=1, max_size=4),
           st.lists(st.integers(min_value=1, max_value=64), min_size=4,
                    max_size=4),
           st.sampled_from(RULE_VARIANTS), st.sampled_from(sorted(MESHES)))
    @settings(max_examples=150, deadline=None)
    def check(axes, dims, variant, mesh):
        jm, pm = pairs[mesh]
        pr = make_rules(variant).with_mesh(pm)
        spec = pr.spec(*axes, dims=dims[:len(axes)])
        assert tuple(spec) == tuple(
            jax_rules(variant, jm).spec(*axes, dims=dims[:len(axes)]))
        sizes = dict(zip(pm.mesh_dim_names, pm.shape))
        used = []
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            es = (entry,) if isinstance(entry, str) else tuple(entry)
            prod = 1
            for ax in es:
                assert ax not in used, (spec, axes)
                used.append(ax)
                prod *= sizes[ax]
            assert dims[i] % prod == 0, (spec, axes, dims)
        placements(spec, pm)

    check()


def test_placements_follow_mesh_order():
    """Every multi-axis entry of the four tables is in mesh order, so JAX's
    major-first sharding and DTensor's mesh-dim order agree; an entry out
    of that order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    pm = MeshShape(("pod", "data", "model"), (2, 2, 2))
    for v in RULE_VARIANTS:
        for name, axes in make_rules(v).table.items():
            if isinstance(axes, tuple):
                ps = placements((None, axes), pm)
                assert all(p == Shard(1) for p, a in zip(
                    ps, pm.mesh_dim_names) if a in axes), (v, name)
    assert placements(("model", None, "data"), pm) == \
        (Replicate(), Shard(2), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements((("model", "data"),), pm)


def test_merge_spec():
    assert sharding.merge_spec((None, "data", "model"), (2, 64, 4, 8),
                               (2, 64, 32)) == (None, "data", "model")
    assert sharding.merge_spec((None, "model", None, "data"),
                               (2, 4, 8, 64), (2, 32, 64)) == \
        (None, "model", "data")
    assert sharding.merge_spec((None, None, None, "data"), (2, 64, 1, 8),
                               (2, 64, 8)) == (None, None, "data")
    with pytest.raises(ValueError, match="minor"):
        sharding.merge_spec((None, None, None, "model"), (2, 64, 4, 8),
                            (2, 64, 32))
    with pytest.raises(ValueError, match="merge"):
        sharding.merge_spec((), (2, 64, 4, 8), (2, 64, 30))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_runs_under_the_forward_rules(policy):
    """The period checkpoint's recompute sees the rules that were active at
    the forward, whichever thread runs the backward (on the card autograd
    runs it on its device thread, where the thread-local rules are
    unset)."""
    rules = make_rules("cp")
    seen = []

    def period(x):
        seen.append(current_rules())
        return (x * 2).sin()
    x = torch.randn(4, requires_grad=True)
    with axis_rules(rules):
        y = remat.run(policy, period, x).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert current_rules() is None
    assert seen == [rules, rules] and x.grad is not None


# the port's 2-D projections: (JAX dims merged into one port dim)
MERGED = {"attn": {"mix_wq": (2, 3), "mix_wk": (2, 3), "mix_wv": (2, 3),
                   "mix_wo": (1, 2)},
          "mla": {"mix_wq_b": (2, 3), "mix_wk_b": (2, 3), "mix_wv_b": (2, 3),
                  "mix_wo": (1, 2)}}


def expected_port_spec(jspec, jshape, kind, nm):
    """The JAX spec on the port's shape: a merged pair's minor entry must be
    None and is dropped."""
    e = list(jspec) + [None] * (len(jshape) - len(jspec))
    pair = MERGED.get(kind, {}).get(nm)
    if pair:
        assert e[pair[1]] is None
        del e[pair[1]]
    while e and e[-1] is None:
        e.pop()
    return tuple(e)


def assert_param_specs_match(cfg_name, reduced, variant, jm, pm):
    jcfg = jax_get_config(cfg_name, reduced=reduced)
    cfg = get_config(cfg_name, reduced=reduced)
    jsh = jax_param_shardings(JaxModel(jcfg), jax_rules(variant, jm))
    psh = param_shardings(Model(cfg, device="cpu"),
                          make_rules(variant).with_mesh(pm))
    jshapes = JaxModel(jcfg).param_shapes()
    port = spec_tree(cfg)
    assert set(psh) == set(jsh)
    for g, sub in jsh.items():
        kind = cfg.pattern[int(g[3:])] if g.startswith("pos") else None
        assert set(psh[g]) == set(sub)
        for nm, js in sub.items():
            want = expected_port_spec(tuple(js.spec), jshapes[g][nm].shape,
                                      kind, nm)
            got = psh[g][nm].spec
            assert tuple(got) == want, (g, nm, got, want)
            placements(got, pm)
            # the spec fits the port's shape
            sizes = dict(zip(pm.mesh_dim_names, pm.shape))
            for d, entry in enumerate(got):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                assert port[g][nm][0][d] % int(np.prod(
                    [sizes[a] for a in axes])) == 0
    return psh


@pytest.mark.parametrize("variant", RULE_VARIANTS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch, variant):
    jm, pm = mesh_pair("(2, 4)")
    assert_param_specs_match(arch, True, variant, jm, pm)


@pytest.mark.parametrize("variant", ["tp", "cp"])
def test_full_width_smollm_heads_do_not_shard(variant):
    """smollm-135m's 9 heads on a (1, 4) mesh: ``heads_w`` falls back to
    replicated on the JAX shape, where the 576 merged columns would
    shard."""
    jm = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    pm = MeshShape(("data", "model"), (1, 4))
    psh = assert_param_specs_match("smollm-135m", False, variant, jm, pm)
    for nm in ("mix_wq", "mix_wk", "mix_wv", "mix_wo"):
        assert "model" not in psh["pos0"][nm].spec, nm
    rules = make_rules(variant).with_mesh(pm)
    assert "model" in rules.spec("layers", "fsdp_embed", "heads_w",
                                 dims=(30, 576, 576))


# ---------------------------------------------------------------------------
# the 8 ranks
# ---------------------------------------------------------------------------

ARCH = R.ARCH


def _jax_step(variant, compression="none"):
    cfg = jax_get_config(ARCH, reduced=True)
    return jax.jit(jax_make_train_step(
        JaxModel(cfg, JaxKnobs(**R.KNOBS)),
        jax_rules(variant, jax_host_mesh(model=4)),
        JaxTrainConfig(grad_accum=2, optimizer=JaxAdamW(**R.OPT),
                       grad_compression=compression)))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 ranks, compute the JAX side meanwhile, wait for the
    ranks; everything each test holds against."""
    in_dir = tmp_path_factory.mktemp("ranks_in")
    out_dir = tmp_path_factory.mktemp("ranks_out")
    tree = numpy_tree(ARCH)
    np.savez(in_dir / "tree.npz", **R.flat(tree))
    b = {"b0": host_batch(ARCH, 0, 4, 32), "b1": host_batch(ARCH, 1, 4, 32),
         "b8": host_batch(ARCH, 0, 8, 32)}
    np.savez(in_dir / "batches.npz", **R.flat(b))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jax_adamw_init(jp)
    steps = {"cp": _jax_step("cp")}
    jp1, jo1, jm1 = steps["cp"](jp, jo, to_jax(b["b0"]))
    jax_ckpt.save(str(in_dir / "jax_ckpt"), 1, {"params": jp1, "opt": jo1})

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    log = open(out_dir / "ranks.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_ranks.py"), str(in_dir),
         str(out_dir)], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        ref = SimpleNamespace(tree=tree, batches=b, jax={}, jax_loss={},
                              out=out_dir)
        ref.jax["cp"], ref.jax_loss["cp"] = _np_tree(jp1), float(jm1["loss"])
        for v in R.VARIANTS[1:]:
            p, _, m = _jax_step(v)(jp, jo, to_jax(b["b0"]))
            ref.jax[v], ref.jax_loss[v] = _np_tree(p), float(m["loss"])
        p, _, m = _jax_step("cp", "int8")(jp, jo, to_jax(b["b0"]))
        ref.jax["cp int8"], ref.jax_loss["cp int8"] = _np_tree(p), \
            float(m["loss"])
        p2, _, m2 = steps["cp"](jp1, jo1, to_jax(b["b1"]))
        ref.jax_step2, ref.jax_step2_loss = _np_tree(p2), float(m2["loss"])
        ref.jax_ckpt = {"params": _np_tree(jp1), "opt": _np_tree(jo1)}
        # the port's unsharded step
        cfg = get_config(ARCH, reduced=True)
        model = Model(cfg, ModelKnobs(**R.KNOBS), device="cpu")
        params = params_from_jax(tree, cfg, "cpu")
        p, _, m = make_train_step(model, TrainConfig(
            grad_accum=2, optimizer=AdamWConfig(**R.OPT)))(
                params, adamw_init(params), to_torch(b["b0"]))
        ref.port = params_to_jax(p, cfg)
        ref.port_loss = float(m["loss"])
        ref.port_gnorm = float(m["grad_norm"])
        ref.cli = train_cli.main(R.CLI)
        proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    if proc.returncode != 0 or not (out_dir / "done").exists():
        tail = (out_dir / "ranks.log").read_text()[-6000:]
        raise AssertionError(f"the 8 ranks failed (rc {proc.returncode}):\n"
                             f"{tail}")
    return ref


def load(path):
    with np.load(path) as z:
        out = {}
        for k in z.files:
            *gs, nm = k.split("__")
            d = out
            for g in gs:
                d = d.setdefault(g, {})
            d[nm] = z[k]
    return out


def assert_close(got, want, rtol=P_RTOL, atol=P_ATOL):
    for g, sub in want.items():
        for nm, w in sub.items():
            np.testing.assert_allclose(got[g][nm], np.asarray(w), rtol=rtol,
                                       atol=atol, err_msg=f"{g}/{nm}")


def assert_bits(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_bits(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_local_shards_match_jax_at_mesh_coordinates(ranks):
    """Each rank's local shard of each parameter under cp on (2, 4) equals
    the JAX array's shard on the device at the same mesh coordinate."""
    jm = jax_host_mesh(model=4)
    jrules = jax_rules("cp", jm)
    jsh = jax_param_shardings(JaxModel(jax_get_config(ARCH, reduced=True)),
                              jrules)
    by_coord = {}
    for r in range(R.WORLD):
        got = load(ranks.out / f"shards_{r}.npz")
        by_coord[tuple(int(c) for c in got.pop("coord"))] = got
    assert sorted(by_coord) == [(i, j) for i in range(2) for j in range(4)]
    n = 0
    for g, sub in ranks.tree.items():
        for nm, a in sub.items():
            arr = jax.device_put(jnp.asarray(a), jsh[g][nm])
            for shard in arr.addressable_shards:
                coord = tuple(int(c) for c in
                              np.argwhere(jm.devices == shard.device)[0])
                mine = by_coord[coord][g][nm]
                np.testing.assert_array_equal(
                    mine, np.asarray(shard.data).reshape(mine.shape),
                    err_msg=f"{g}/{nm} at {coord}")
                n += 1
    assert n == R.WORLD * sum(len(s) for s in ranks.tree.values())


@pytest.mark.parametrize("case", [c[0] for c in R.OP_CASES])
def test_op_rule_gradients(ranks, case):
    """The op on sharded DTensors: its output and every input's gradient
    within 1e-5 x scale of the op on whole tensors."""
    errs = json.loads((ranks.out / "ops.json").read_text())[case]
    assert max(errs) <= OP_TOL, errs


def test_replicated_weight_gradient_needs_partial(ranks):
    """A's rows over data and B replicated: with the rule's ``Partial``
    gradient placement for B its gradient is right; left at DTensor's
    default (the forward's, replicated) it is wrong by the sum over the
    other data rank's rows."""
    got = json.loads((ranks.out / "ops.json").read_text())
    label = R.OP_CASES[0][0]
    assert max(got[label]) <= OP_TOL
    out, da, db = got["trap: " + label]
    assert out <= OP_TOL and da <= OP_TOL
    assert db > 0.1, db


def test_cp_flash_runs_each_ranks_query_shard(ranks):
    """Under cp on (2, 4) every local flash call of the sharded step gets
    the rank's S / 4 query rows (S 32) against all S keys, at its global
    offset (its model coordinate x S / 4, as the reference's attention
    masks its sequence-sharded queries with global positions), and every
    attention output is ``Shard(1)`` on ``model``."""
    S, m = 32, 4
    offsets = set()
    for r in range(R.WORLD):
        got = json.loads((ranks.out / f"flash_cp_{r}.json").read_text())
        j = got["coord"][1]
        assert got["local"] and all(c == [S // m, S, j * S // m]
                                    for c in got["local"]), got["local"]
        assert got["out"] and all(pl == [0, 1]
                                  for pl in got["out"]), got["out"]
        offsets.add(j * S // m)
    assert offsets == {0, 8, 16, 24}


@pytest.mark.parametrize("variant", R.VARIANTS + ("cp int8",))
def test_sharded_step_matches_jax(ranks, variant):
    steps = json.loads((ranks.out / "steps.json").read_text())
    np.testing.assert_allclose(steps[variant]["loss"],
                               ranks.jax_loss[variant], rtol=LOSS_RTOL)
    assert_close(load(ranks.out / f"step_{variant}.npz"), ranks.jax[variant])


@pytest.mark.parametrize("variant", R.VARIANTS + ("cp dots",))
def test_sharded_step_matches_unsharded_port(ranks, variant):
    """Against the port's unsharded step: the loss, the global gradient
    norm (``optim.global_norm`` over DTensor leaves) and the parameters;
    "cp dots" runs the period checkpoint's "dots" stash on local
    tensors."""
    steps = json.loads((ranks.out / "steps.json").read_text())
    np.testing.assert_allclose(steps[variant]["loss"], ranks.port_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(steps[variant]["grad_norm"],
                               ranks.port_gnorm, rtol=LOSS_RTOL)
    assert_close(load(ranks.out / f"step_{variant}.npz"), ranks.port)


def test_grad_accum_invariance(ranks):
    """The reference's ga 1 vs ga 4 case, sharded under cp on (2, 4)."""
    steps = json.loads((ranks.out / "steps.json").read_text())
    np.testing.assert_allclose(steps["ga1"]["loss"], steps["ga4"]["loss"],
                               rtol=1e-5)
    assert_close(load(ranks.out / "ga4.npz"), load(ranks.out / "ga1.npz"),
                 rtol=5e-3, atol=1e-4)


def test_elastic_reshard(ranks):
    """Saved from (8, 1) under cp, restored onto (2, 4): the same bits, on
    the (2, 4) mesh."""
    got = load(ranks.out / "elastic.npz")
    assert tuple(got.pop("mesh")) == (2, 4)
    cfg = get_config(ARCH, reduced=True)
    want = params_from_jax(ranks.tree, cfg, "cpu")
    assert_bits(got, {g: {nm: t.numpy() for nm, t in sub.items()}
                      for g, sub in want.items()})


def test_port_sharded_checkpoint_restores_in_jax(ranks):
    """The ranks' checkpoint of their sharded cp step, read by the JAX
    ``restore`` onto its (2, 4) mesh: the port's bits, on that mesh."""
    want = load(ranks.out / "step_cp.npz")
    like = jax.eval_shape(lambda: {"params": jax.tree.map(jnp.asarray,
                                                          ranks.tree)})
    jm = jax_host_mesh(model=4)
    sh = {"params": jax_param_shardings(
        JaxModel(jax_get_config(ARCH, reduced=True)), jax_rules("cp", jm))}
    tree, man = jax_ckpt.restore(str(ranks.out / "port_ckpt"), 1,
                                 like, shardings=sh)
    assert man["step"] == 1
    assert_bits(_np_tree(tree["params"]), want)
    leaf = jax.tree.leaves(tree)[0]
    assert isinstance(leaf.sharding, JaxNamedSharding)
    assert leaf.sharding.mesh.shape == jm.shape


def test_jax_sharded_checkpoint_resumes_in_port(ranks):
    """The JAX package's checkpoint of its sharded cp step, restored onto
    the ranks' (2, 4) mesh: its bits; one more sharded port step from it
    lands on the JAX step 2."""
    got = load(ranks.out / "jax_ckpt_restored.npz")
    assert int(got.pop("step")) == 1
    want = ranks.jax_ckpt
    assert_bits(got, {"params": want["params"],
                      "opt": {"m": want["opt"]["m"], "v": want["opt"]["v"],
                              "step": want["opt"]["step"]}})
    step2 = load(ranks.out / "jax_ckpt_step2.npz")
    np.testing.assert_allclose(float(step2.pop("loss")),
                               ranks.jax_step2_loss, rtol=LOSS_RTOL)
    assert_close(step2, ranks.jax_step2)


def test_cli_model_axis_matches_one_device(ranks):
    """``launch/train.py --model-axis 4`` in the 8 ranks against the same
    command on one device."""
    got = json.loads((ranks.out / "cli.json").read_text())
    np.testing.assert_allclose([h["loss"] for h in got["straight"]],
                               [h["loss"] for h in ranks.cli["history"]],
                               rtol=LOSS_RTOL)
    cfg = get_config(ARCH, reduced=True)
    assert_close(load(ranks.out / "cli_params.npz"),
                 params_to_jax(ranks.cli["params"], cfg))


def test_cli_model_axis_resumes(ranks):
    """The same command after its step-4 checkpoint is deleted resumes from
    step 2 and ends on the straight run's losses and state, bit for bit."""
    got = json.loads((ranks.out / "cli.json").read_text())
    assert got["resumed_start"] == 2
    assert [h["loss"] for h in got["resumed"]] == \
        [h["loss"] for h in got["straight"][2:]]
    assert got["state_equal"]
