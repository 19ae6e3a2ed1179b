"""The rank side of ``tests/test_torch_sharded.py``: one gloo group of 8
ranks on the CPU runs every multi-rank case of that file and writes what it
got for the parent to hold against the JAX package.

    PYTHONPATH=src python tests/torch_sharded_ranks.py IN_DIR OUT_DIR

``IN_DIR`` holds the parent's inputs: ``tree.npz`` (reduced smollm-135m's
parameters in the JAX layout, keys ``group__name``), ``batches.npz`` (the
synthetic batches) and ``jax_ckpt/`` (a checkpoint that the JAX package
saved from its sharded step).  This file imports no JAX: the JAX side runs
in the parent.
"""

from __future__ import annotations

import json
import shutil
import sys
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
ARCH = "smollm-135m"
KNOBS = dict(kv_chunk=16, ssm_chunk=8)
VARIANTS = ("cp", "dp", "tp", "cp_fsdp")
OPT = dict(lr=1e-3, warmup=1)
# the launcher's command in the ranks and, without --model-axis, in the
# parent
CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
       "--batch", "4", "--seq", "16", "--grad-accum", "2", "--ckpt-every",
       "2", "--log-every", "1"]


def load_tree(in_dir: Path):
    with np.load(in_dir / "tree.npz") as z:
        tree = {}
        for k in z.files:
            g, nm = k.split("__", 1)
            tree.setdefault(g, {})[nm] = z[k]
    return tree


def flat(tree, prefix=""):
    """{"a__b": numpy} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}__{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v.detach().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def batches(in_dir: Path, name: str):
    with np.load(in_dir / "batches.npz") as z:
        return {k: torch.from_numpy(z[f"{name}__{k}"])
                for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# the cases, each run by every rank in order
# ---------------------------------------------------------------------------

def setup(in_dir):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model, ModelKnobs
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
    return cfg, model, params_from_jax(load_tree(in_dir), cfg, "cpu")


def rules_on(model_axis: int, variant: str):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    mesh = make_host_mesh(model_axis, device_type="cpu")
    return make_rules(variant).with_mesh(mesh)


def case_local_shards(rank, in_dir, out_dir):
    """Each rank's local shards under cp on (2, 4), with its mesh
    coordinate."""
    from repro_torch.train.step import shard_params
    cfg, model, params = setup(in_dir)
    rules = rules_on(4, "cp")
    sh = shard_params(model, params, rules)
    local = {g: {nm: t.to_local() for nm, t in sub.items()}
             for g, sub in sh.items()}
    np.savez(out_dir / f"shards_{rank}.npz",
             coord=np.asarray(rules.mesh.get_coordinate()), **flat(local))


def _grads(fn, inputs, g_out):
    """(output, input gradients) of sum(fn(*inputs) * g_out), whole."""
    from torch.distributed.tensor import DTensor
    out = fn(*inputs)
    whole = out.full_tensor() if isinstance(out, DTensor) else out
    (whole * g_out).sum().backward()
    grads = [t.grad.full_tensor() if isinstance(t.grad, DTensor) else t.grad
             for t in inputs]
    return whole.detach(), grads


# (name, op, global shapes, placements per input on the (2, 4) mesh); S0 =
# Shard(0) etc., R = Replicate
OP_CASES = [
    ("matmul A rows over data, B replicated", "matmul", [(8, 12), (12, 16)],
     [("S0", "R"), ("R", "R")]),
    ("matmul A rows over data, K over model", "matmul", [(8, 12), (12, 16)],
     [("S0", "S1"), ("R", "S0")]),
    ("matmul B columns over both", "matmul", [(8, 12), (12, 16)],
     [("R", "R"), ("S1", "S1")]),
    ("matmul A K-sharded, B replicated (gathered)", "matmul",
     [(8, 12), (12, 16)], [("S1", "R"), ("R", "S1")]),
    ("linear (B, S, K) rows over both, FSDP weight", "linear",
     [(4, 8, 12), (12, 16)], [("S0", "S1"), ("S0", "S1")]),
    ("rmsnorm rows over both", "rmsnorm", [(4, 8, 16), (16,)],
     [("S0", "S1"), ("R", "R")]),
    ("rmsnorm D sharded, w sharded (gathered)", "rmsnorm",
     [(4, 8, 16), (16,)], [("S2", "S0"), ("S0", "S0")]),
    ("flash batch over data, heads over model", "flash",
     [(2, 16, 8, 8), (2, 16, 4, 8), (2, 16, 4, 8)],
     [("S0", "S2"), ("S0", "S2"), ("S0", "S2")]),
    ("flash seq over model (gathered)", "flash",
     [(2, 18, 8, 8), (2, 18, 4, 8), (2, 18, 4, 8)],
     [("S0", "S1"), ("S0", "S1"), ("S0", "S1")]),
    ("flash seq over model (queries split at their offsets)", "flash",
     [(2, 16, 8, 8), (2, 16, 4, 8), (2, 16, 4, 8)],
     [("S0", "S1"), ("S0", "S1"), ("S0", "S1")]),
    ("flash seq over both (queries split at their offsets)", "flash",
     [(2, 16, 8, 8), (2, 16, 4, 8), (2, 16, 4, 8)],
     [("S1", "S1"), ("S1", "S1"), ("S1", "S1")]),
    ("flash KV heads that do not split (gathered)", "flash",
     [(2, 16, 8, 8), (2, 16, 2, 8), (2, 16, 2, 8)],
     [("R", "S2"), ("R", "S2"), ("R", "S2")]),
]


def _op(name):
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    return {"matmul": ops.matmul, "linear": layers.linear,
            "rmsnorm": lambda x, w: ops.rmsnorm(x, w, eps=1e-5),
            "flash": lambda q, k, v: ops.flash_attention(q, k, v,
                                                         causal=True)}[name]


def _placement(code):
    from torch.distributed.tensor import Replicate, Shard
    return Replicate() if code == "R" else Shard(int(code[1:]))


def run_op_case(mesh, op, shapes, places, seed):
    """(max error / scale of the output, of each gradient) of the sharded op
    against the op on whole tensors."""
    from torch.distributed.tensor import distribute_tensor
    gen = torch.Generator().manual_seed(seed)
    whole = [torch.randn(s, generator=gen) for s in shapes]
    fn = _op(op)
    ref_in = [t.clone().requires_grad_(True) for t in whole]
    ref_out = fn(*ref_in)
    g_out = torch.randn(ref_out.shape, generator=gen)
    ref_out, ref_g = _grads(fn, ref_in, g_out)
    dts = [distribute_tensor(t, mesh, [_placement(c) for c in p],
                             src_data_rank=None).requires_grad_(True)
           for t, p in zip(whole, places)]
    out, grads = _grads(fn, dts, g_out)

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return [err(out, ref_out)] + [err(a, b) for a, b in zip(grads, ref_g)]


def case_op_rules(rank, in_dir, out_dir):
    """Each op's placement rule on sharded DTensors against the op on whole
    tensors; then the replicated-weight matmul with its gradient placements
    left at DTensor's default (the forward's), which the rule overrides."""
    from repro_torch.kernels import ops
    mesh = rules_on(4, "cp").mesh
    got = {}
    for i, (label, op, shapes, places) in enumerate(OP_CASES):
        got[label] = run_op_case(mesh, op, shapes, places, seed=i)
    rule = ops.matmul_rule

    def default_grads(a, b):
        ins, outs, _ = rule(a, b)
        return ins, outs, ins
    ops.matmul_rule = default_grads
    try:
        label, op, shapes, places = OP_CASES[0]
        got["trap: " + label] = run_op_case(mesh, op, shapes, places, seed=0)
    finally:
        ops.matmul_rule = rule
    if rank == 0:
        (out_dir / "ops.json").write_text(json.dumps(got))


@contextmanager
def recording_flash():
    """Record, while the block runs, each local flash call's (query rows,
    keys, q_offset) and each sharded flash call's output placements (a
    wrapper of ``ops._flash_local`` and ``ops.flash_attention``, put back
    after)."""
    from repro_torch.kernels import ops
    calls = {"local": [], "out": []}
    local, top = ops._flash_local, ops.flash_attention

    def spy_local(q, k, v, causal, bk, scale, q_offset=None):
        calls["local"].append([q.shape[1], k.shape[1], q_offset])
        return local(q, k, v, causal, bk, scale, q_offset)

    def spy(q, k, v, **kw):
        o = top(q, k, v, **kw)
        # the dim each mesh dim shards (None: not sharded)
        calls["out"].append([p.dim if p.is_shard() else None
                             for p in o.placements])
        return o
    ops._flash_local, ops.flash_attention = spy_local, spy
    try:
        yield calls
    finally:
        ops._flash_local, ops.flash_attention = local, top


def sharded_step(model, params, rules, batch, grad_accum=2,
                 compression="none"):
    """One sharded step from whole ``params``: (whole params, metrics,
    the placed state)."""
    from repro_torch.parallel.sharding import gather, place
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, opt_shardings,
                                        placed_train_step, shard_params)
    tc = TrainConfig(grad_accum=grad_accum, optimizer=AdamWConfig(**OPT),
                     grad_compression=compression)
    step = placed_train_step(model, rules, tc)
    ps = shard_params(model, params, rules)
    os_ = place(adamw_init(params), opt_shardings(model, rules))
    p2, o2, m = step(ps, os_, batch)
    return gather(p2), {k: float(v) for k, v in m.items()}, (p2, o2)


def case_steps(rank, in_dir, out_dir):
    """One step of reduced smollm-135m (ga 2, 4 x 32) under each variant
    on (2, 4), and under cp with remat "dots" and with the int8 round
    trip; ga 1 and ga 4 under cp on an 8 x 32 batch; the cp step's
    state saved as a port checkpoint for the parent's JAX restore."""
    from repro_torch.models.convert import params_to_jax
    from repro_torch.models.model import Model
    from repro_torch.train import checkpoint as ckpt
    cfg, model, params = setup(in_dir)
    b = batches(in_dir, "b0")
    out = {}
    for v in VARIANTS:
        rules = rules_on(4, v)
        with recording_flash() as calls:
            whole, m, state = sharded_step(model, params, rules, b)
        if v == "cp":
            (out_dir / f"flash_cp_{rank}.json").write_text(json.dumps({
                "coord": list(rules.mesh.get_coordinate()), **calls}))
        out[v] = m
        if rank == 0:
            np.savez(out_dir / f"step_{v}.npz",
                     **flat(params_to_jax(whole, cfg)))
        if v == "cp":
            ckpt.save(str(out_dir / "port_ckpt"), 1,
                      {"params": state[0], "opt": state[1]}, cfg=cfg)
    # the period checkpoint's "dots" stash holding each rank's local tensors
    dots = Model(cfg, replace(model.knobs, remat="dots"), device="cpu")
    whole, out["cp dots"], _ = sharded_step(dots, params, rules_on(4, "cp"),
                                            b)
    if rank == 0:
        np.savez(out_dir / "step_cp dots.npz",
                 **flat(params_to_jax(whole, cfg)))
    whole, out["cp int8"], _ = sharded_step(model, params, rules_on(4, "cp"),
                                            b, compression="int8")
    if rank == 0:
        np.savez(out_dir / "step_cp int8.npz",
                 **flat(params_to_jax(whole, cfg)))
    b8 = batches(in_dir, "b8")
    rules = rules_on(4, "cp")
    for ga in (1, 4):
        whole, m, _ = sharded_step(model, params, rules, b8, grad_accum=ga)
        out[f"ga{ga}"] = m
        if rank == 0:
            np.savez(out_dir / f"ga{ga}.npz",
                     **flat(params_to_jax(whole, cfg)))
    if rank == 0:
        (out_dir / "steps.json").write_text(json.dumps(out))


def case_checkpoints(rank, in_dir, out_dir):
    """(a) The elastic restore: the parameters placed under cp on (8, 1),
    saved, restored onto (2, 4); (b) the JAX package's checkpoint of its
    sharded cp step restored onto (2, 4), then one more port step from it
    on batch 1."""
    from repro_torch.models.convert import params_to_jax
    from repro_torch.models.model import spec_tree
    from repro_torch.parallel.sharding import gather
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, opt_shardings,
                                        param_shardings, placed_train_step,
                                        shard_params)
    cfg, model, params = setup(in_dir)
    like = {g: {nm: torch.empty(shape, device="meta")
                for nm, (shape, _) in sub.items()}
            for g, sub in spec_tree(cfg).items()}
    d = str(out_dir / "elastic")
    ckpt.save(d, 1, shard_params(model, params, rules_on(1, "cp")), cfg=cfg)
    rules_b = rules_on(4, "cp")
    got, _ = ckpt.restore(d, 1, like, cfg=cfg,
                          shardings=param_shardings(model, rules_b))
    mesh_shape = tuple(next(iter(got["final"].values())).device_mesh.shape)
    restored = gather(got)
    if rank == 0:
        np.savez(out_dir / "elastic.npz", mesh=np.asarray(mesh_shape),
                 **flat(restored))

    sh = {"params": param_shardings(model, rules_b),
          "opt": opt_shardings(model, rules_b)}
    tree, man = ckpt.restore(str(in_dir / "jax_ckpt"), 1,
                             {"params": like, "opt": adamw_init(like)},
                             cfg=cfg, shardings=sh)
    whole = gather(tree)
    step = placed_train_step(model, rules_b, TrainConfig(
        grad_accum=2, optimizer=AdamWConfig(**OPT)))
    p2, _, m = step(tree["params"], tree["opt"], batches(in_dir, "b1"))
    p2 = gather(p2)
    if rank == 0:
        np.savez(out_dir / "jax_ckpt_restored.npz",
                 step=np.asarray(man["step"]),
                 **flat({"params": params_to_jax(whole["params"], cfg),
                         "opt": {"m": params_to_jax(whole["opt"]["m"], cfg),
                                 "v": params_to_jax(whole["opt"]["v"], cfg),
                                 "step": whole["opt"]["step"]}}))
        np.savez(out_dir / "jax_ckpt_step2.npz",
                 loss=np.asarray(float(m["loss"])),
                 **flat(params_to_jax(p2, cfg)))


def case_cli(rank, in_dir, out_dir):
    """``launch/train.py --model-axis 4`` on the 8 ranks: a straight run
    of 4 steps, then the same command after its step-4 checkpoint is
    deleted, which resumes from step 2."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.convert import params_to_jax
    d = out_dir / "cli_ck"
    argv = CLI + ["--model-axis", "4", "--ckpt-dir", str(d)]
    straight = train_cli.main(argv)
    if rank == 0:
        shutil.rmtree(d / "step_0000000004")
    dist.barrier()
    resumed = train_cli.main(argv)
    if rank == 0:
        cfg = get_config(ARCH, reduced=True)
        np.savez(out_dir / "cli_params.npz",
                 **flat(params_to_jax(straight["params"], cfg)))
        same = all(torch.equal(a, b) for a, b in zip(
            flat_tensors(straight), flat_tensors(resumed)))
        (out_dir / "cli.json").write_text(json.dumps({
            "straight": straight["history"], "resumed": resumed["history"],
            "resumed_start": resumed["start"], "state_equal": same}))


def flat_tensors(run):
    from repro_torch.train.checkpoint import _flatten
    return [t for _, t in _flatten({"p": run["params"], "o": run["opt"]})]


CASES = (case_local_shards, case_op_rules, case_steps, case_checkpoints,
         case_cli)


def _rank(rank, in_dir, out_dir):
    torch.set_num_threads(1)
    # a file store: no port to pick, none to race for
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        for case in CASES:
            case(rank, Path(in_dir), Path(out_dir))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv):
    in_dir, out_dir = argv
    mp.spawn(_rank, args=(in_dir, out_dir), nprocs=WORLD)
    Path(out_dir, "done").write_text("ok")


if __name__ == "__main__":
    main(sys.argv[1:])
