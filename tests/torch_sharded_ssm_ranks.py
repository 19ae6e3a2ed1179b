"""The rank side of ``tests/test_torch_sharded_ssm.py``: one gloo group of 8
ranks on the CPU runs every multi-rank case of that file and writes what it
got for the parent to hold against the JAX package.

    PYTHONPATH=src:tests python tests/torch_sharded_ssm_ranks.py IN_DIR OUT_DIR

``IN_DIR`` holds the parent's inputs: ``tree_<arch>.npz`` (the reduced
configurations' parameters in the JAX layout, keys ``group__name``),
``blocks.npz`` (each mixer's input x and output cotangent g) and
``batches.npz``.  This file imports no JAX: the JAX side runs in the
parent.
"""

from __future__ import annotations

import json
import logging
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_expert_parallel_ranks import load_tree
from torch_sharded_ranks import KNOBS, flat, rules_on, sharded_step
from torch_sharded_serve_ranks import COLLECTIVES, CommBytes

WORLD = 8
ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
VARIANTS = ("cp", "tp", "dp")
# (mixer, the configuration whose reduced widths and layer 0 it takes, the
# group holding it)
MIXERS = (("mamba", "jamba-v0.1-52b", "pos0"), ("mlstm", "xlstm-125m", "pos0"),
          ("slstm", "xlstm-125m", "pos1"))
# the weight whose gradient the region sums at its boundary
REGION_WEIGHT = {"mamba": "a_log", "slstm": "r", "mlstm": "wq"}
BLOCK_SHAPE = (4, 16)            # batch, seq: two chunks of KNOBS' 8


def block_params(in_dir, mixer, arch, group):
    """Layer 0's mixer weights (period 0 of ``group``), unstacked."""
    tree = load_tree(in_dir / f"tree_{arch}.npz")
    return {k[4:]: torch.from_numpy(v[0].copy())
            for k, v in tree[group].items() if k.startswith("mix_")}


def run_block(mixer, cfg, p, x, g, rules=None):
    """(y, {name: gradient}) of sum(block(p, x) * g), whole; under
    ``rules`` every tensor placed as the sharded step places it (the
    weights by their logical axes, x by batch/seq/embed)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import ssm
    from repro_torch.models.model import _kind_axes
    from repro_torch.parallel.sharding import (NamedSharding, axis_rules,
                                               distribute)
    fn = {"mamba": ssm.mamba_block, "mlstm": ssm.mlstm_block,
          "slstm": ssm.slstm_block}[mixer]
    ins = dict(p, x=x)
    if rules is not None:
        axes = {nm: ax for nm, (_, ax) in _kind_axes(cfg, mixer).items()}
        axes["x"] = ("batch", "seq", "embed")
        ins = {k: distribute(t, NamedSharding(rules.mesh, rules.spec(
            *axes[k], dims=t.shape))) for k, t in ins.items()}
    ins = {k: t.detach().requires_grad_(True) for k, t in ins.items()}
    with axis_rules(rules):
        y, _ = fn({k: ins[k] for k in p}, ins["x"], cfg,
                  chunk=KNOBS["ssm_chunk"])
        y = y.full_tensor() if isinstance(y, DTensor) else y
    (y * g).sum().backward()
    whole = {k: t.grad.full_tensor() if isinstance(t.grad, DTensor)
             else t.grad for k, t in ins.items()}
    return y.detach(), whole


# ---------------------------------------------------------------------------
# the cases, each run by every rank in order
# ---------------------------------------------------------------------------

def case_blocks(rank, in_dir, out_dir):
    """Each mixer's block on (2, 4) under cp: its output and every
    gradient, on one rank's plain tensors too, and rank 0's collectives
    (the block's and its causal conv's); then with the manual region's
    gradients left at DTensor's default (the forward's placements, no
    share of a replicated output's cotangent)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding
    with np.load(in_dir / "blocks.npz") as z:
        xs = {k: torch.from_numpy(z[k]) for k in z.files}
    rules = rules_on(4, "cp")
    out, comm = {}, {}
    for mixer, arch, group in MIXERS:
        cfg = get_config(arch, reduced=True)
        p = block_params(in_dir, mixer, arch, group)
        x, g = xs[f"{mixer} x"], xs[f"{mixer} g"]
        for tag, r in (("cp", rules), ("one", None)):
            y, grads = run_block(mixer, cfg, p, x, g, r)
            out[f"{mixer} {tag} y"] = y
            out.update({f"{mixer} {tag} d{k}": t for k, t in grads.items()})
        # rank 0's collectives of the block's forward and backward under
        # cp, and those of its causal conv (plain PyTorch on DTensors)
        block, conv = CommBytes(), CommBytes()
        inner = ssm.causal_conv

        def counted(*a, **kw):
            with conv:
                return inner(*a, **kw)
        ssm.causal_conv = counted
        try:
            with block:
                run_block(mixer, cfg, p, x, g, rules)
        finally:
            ssm.causal_conv = inner
        comm[mixer] = {name: {k: {"calls": c.calls[k], "bytes": c.bytes[k]}
                              for k in c.calls if k in COLLECTIVES}
                       for name, c in (("block", block),
                                       ("causal_conv", conv))}
        rule = sharding.region_grads
        sharding.region_grads = lambda in_pl, out_pl, mesh: (
            in_pl, [1.0] * len(out_pl))
        try:
            _, grads = run_block(mixer, cfg, p, x, g, rules)
        finally:
            sharding.region_grads = rule
        out.update({f"{mixer} default d{k}": t for k, t in grads.items()})
    if rank == 0:
        np.savez(out_dir / "blocks.npz",
                 **{k: t.numpy() for k, t in out.items()})
        (out_dir / "comm.json").write_text(json.dumps(comm, indent=1))


def case_steps(rank, in_dir, out_dir):
    """One step of reduced xlstm-125m and jamba (ga 2, 4 x 32, AdamW lr
    1e-3 warmup 1, ssm_chunk 8) under cp, tp and dp on (2, 4)."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.models.model import Model, ModelKnobs
    with np.load(in_dir / "batches.npz") as z:
        b = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    losses = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
        params = params_from_jax(load_tree(in_dir / f"tree_{arch}.npz"),
                                 cfg, "cpu")
        for v in VARIANTS:
            whole, m, _ = sharded_step(model, params, rules_on(4, v), b)
            losses[f"{arch} {v}"] = m["loss"]
            if rank == 0:
                np.savez(out_dir / f"step_{arch} {v}.npz",
                         **flat(params_to_jax(whole, cfg)))
    if rank == 0:
        (out_dir / "steps.json").write_text(json.dumps(losses))


CASES = (case_blocks, case_steps)


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
