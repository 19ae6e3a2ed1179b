"""The rank side of ``tests/test_torch_expert_parallel.py``: one gloo group
of 8 ranks on the CPU runs every multi-rank case of that file and writes
what it got for the parent to hold against the JAX package.

    PYTHONPATH=src python tests/torch_expert_parallel_ranks.py IN_DIR OUT_DIR

``IN_DIR`` holds the parent's inputs: ``moe.npz`` (one MoE FFN's weights,
its input x and the output's cotangent g), ``tree_<arch>.npz`` (the reduced
configurations' parameters in the JAX layout, keys ``group__name``),
``batches.npz`` and ``ring.npz`` (the ring's (8, m) contributions).  This
file imports no JAX: the JAX side runs in the parent.
"""

from __future__ import annotations

import json
import logging
import sys
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_sharded_ranks import KNOBS, flat, rules_on, sharded_step

WORLD = 8
MOE_ARCH = "phi3.5-moe"
ARCHS = (MOE_ARCH, "deepseek-v2")
REGIMES = ("cp", "tp", "dp")
# (case, capacity factor, zero router)
MOE_CASES = (("cf8", 8.0, False), ("cf1", 1.0, False), ("zero", 1.0, True))
VARIANTS = ("cp", "dp", "tp", "cp_fsdp")
MOE_WEIGHTS = ("router", "w_gate", "w_up", "w_down")
# the launcher's command in the ranks
CLI = ["--arch", MOE_ARCH, "--reduced", "--device", "cpu", "--steps", "2",
       "--batch", "4", "--seq", "16", "--grad-accum", "2", "--log-every",
       "1", "--model-axis", "4"]


def load_tree(path: Path):
    with np.load(path) as z:
        tree = {}
        for k in z.files:
            g, nm = k.split("__", 1)
            tree.setdefault(g, {})[nm] = z[k]
    return tree


def moe_cfg(cf: float):
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH, reduced=True)
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# the cases, each run by every rank in order
# ---------------------------------------------------------------------------

def moe_run(rules, cfg, p, x, g, dispatch, routing=None):
    """(y, {name: gradient}) of sum(moe_ffn(p, x) * g), every tensor placed
    as the sharded step places it (the weights by their logical axes, x by
    batch/seq/embed), whole."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import (NamedSharding, axis_rules,
                                               distribute)
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    axes = {"router": (("fsdp_embed", None), (D, E)),
            "w_gate": (("expert", "fsdp_embed", "ffn"), (E, D, F)),
            "w_up": (("expert", "fsdp_embed", "ffn"), (E, D, F)),
            "w_down": (("expert", "ffn", "fsdp_embed"), (E, F, D)),
            "x": (("batch", "seq", "embed"), tuple(x.shape))}
    ins = dict(p, x=x)
    placed = {k: distribute(ins[k], NamedSharding(
        rules.mesh, rules.spec(*ax, dims=shape))).requires_grad_(True)
        for k, (ax, shape) in axes.items()}
    with axis_rules(rules):
        y = _whole(moe.moe_ffn({k: placed[k] for k in MOE_WEIGHTS},
                               placed["x"], cfg, dispatch=dispatch,
                               routing=routing))
    (y * g).sum().backward()
    return y.detach(), {k: _whole(t.grad) for k, t in placed.items()}


def case_moe(rank, in_dir, out_dir):
    """``moe_ffn`` on (2, 4): ``a2a`` under cp, tp and dp at capacity
    factors 8 and 1, and with a zero router at 1 (tied logits; pairs drop)
    (each rank's routing gathered on rank 0); ``sort`` and ``dense`` under
    cp at 1."""
    with np.load(in_dir / "moe.npz") as z:
        p = {k: torch.from_numpy(z[k]) for k in MOE_WEIGHTS}
        x, g = torch.from_numpy(z["x"]), torch.from_numpy(z["g"])
    out, routes = {}, {}
    for case, cf, zero in MOE_CASES:
        pc = dict(p, router=torch.zeros_like(p["router"])) if zero else p
        for v in REGIMES:
            rules = rules_on(4, v)
            routing = [] if zero else None
            y, grads = moe_run(rules, moe_cfg(cf), pc, x, g, "a2a", routing)
            out[f"{case} {v} y"] = y
            out.update({f"{case} {v} d{k}": t for k, t in grads.items()})
            if zero:
                idx, kept = routing[0]
                got = [None] * WORLD
                dist.all_gather_object(got, (
                    tuple(rules.mesh.get_coordinate()), idx.numpy(),
                    kept.numpy()))
                routes[v] = got
    for dispatch in ("sort", "dense"):
        y, grads = moe_run(rules_on(4, "cp"), moe_cfg(1.0), p, x, g,
                           dispatch)
        out[f"{dispatch} cp y"] = y
        out.update({f"{dispatch} cp d{k}": t for k, t in grads.items()})
    if rank == 0:
        np.savez(out_dir / "moe.npz",
                 **{k: t.numpy() for k, t in out.items()})
        np.savez(out_dir / "routes.npz", **{
            f"{v}__{r}__{part}": np.asarray(a)
            for v, got in routes.items() for r, entry in enumerate(got)
            for part, a in zip(("coord", "idx", "kept"), entry)})


def case_steps(rank, in_dir, out_dir):
    """One step of reduced phi3.5-moe and deepseek-v2 (ga 2, 4 x 32, AdamW
    lr 1e-3 warmup 1) under each variant on (2, 4); phi3.5-moe at capacity
    factor 8 under cp too."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.models.model import Model, ModelKnobs
    with np.load(in_dir / "batches.npz") as z:
        b = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    losses = {}
    runs = [(arch, v, get_config(arch, reduced=True)) for arch in ARCHS
            for v in VARIANTS] + [(MOE_ARCH, "cp cf8", moe_cfg(8.0))]
    for arch, v, cfg in runs:
        model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
        params = params_from_jax(load_tree(in_dir / f"tree_{arch}.npz"),
                                 cfg, "cpu")
        whole, m, _ = sharded_step(model, params,
                                   rules_on(4, v.split()[0]), b)
        losses[f"{arch} {v}"] = m["loss"]
        if rank == 0:
            np.savez(out_dir / f"step_{arch} {v}.npz",
                     **flat(params_to_jax(whole, cfg)))
    if rank == 0:
        (out_dir / "steps.json").write_text(json.dumps(losses))


def case_ring(rank, in_dir, out_dir):
    """``ring_allreduce_int8`` over an (8,) ``data`` mesh: every rank's row
    of the result, gathered on rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.compression import ring_allreduce_int8
    from repro_torch.parallel.sharding import NamedSharding, P, distribute
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    with np.load(in_dir / "ring.npz") as z:
        x = torch.from_numpy(z["x"])
    xs = distribute(x, NamedSharding(mesh, P("data")))
    out = ring_allreduce_int8(xs, mesh, "data")
    assert out.placements == (Shard(0),)
    rows = [None] * WORLD
    dist.all_gather_object(rows, (rank, out.to_local().numpy()))
    if rank == 0:
        np.savez(out_dir / "ring.npz",
                 **{f"row{r}": a[0] for r, a in rows})


def case_cli(rank, in_dir, out_dir):
    """``launch/train.py --arch phi3.5-moe --reduced --model-axis 4`` on the
    8 ranks, then the same steps through ``placed_train_step`` in process:
    the launcher's weights (``Model.init`` from its seed), batches
    (``batch_iterator``) and AdamW."""
    from repro_torch.configs.base import Shape
    from repro_torch.launch import train as train_cli
    from repro_torch.parallel.sharding import place
    from repro_torch.train.data import DataConfig, batch_iterator
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import (opt_shardings, param_shardings,
                                        placed_train_step)
    run = train_cli.main(CLI)
    args = train_cli.parse(CLI)
    rules = rules_on(args.model_axis, args.variant)
    cfg, shape, model, _ = train_cli.build(args, rules)
    tc = train_cli.train_config(args)
    params = model.init(torch.Generator().manual_seed(args.seed))
    opt = place(adamw_init(params), opt_shardings(model, rules))
    params = place(params, param_shardings(model, rules))
    step = placed_train_step(model, rules, tc)
    it = batch_iterator(cfg, Shape("cli", args.seq, args.batch, "train"),
                        DataConfig(seed=args.seed))
    losses = []
    for _ in range(args.steps):
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    if rank == 0:
        (out_dir / "cli.json").write_text(json.dumps({
            "cli": [h["loss"] for h in run["history"]],
            "in_process": losses}))


CASES = (case_moe, case_steps, case_ring, case_cli)


def _rank(rank, in_dir, out_dir):
    torch.set_num_threads(1)
    # DTensor's notes on sequential all-gathers over two mesh dims
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
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
