"""The rank side of ``tests/test_torch_pipeline.py``: one gloo group of 8
ranks on the CPU runs the port's ``pipeline_loss`` and its gradients on
(pod 2, data 2, model 2) and on (pod 1, data 4, model 2); then the parent
process alone, in a world-1 group, runs it on (1, 1, 1) beside
``Model.loss`` on the same microbatches.  It writes what it got for the
parent to hold against the JAX package.

    PYTHONPATH=src python tests/torch_pipeline_ranks.py IN_DIR OUT_DIR

``IN_DIR`` holds ``tree.npz`` (reduced smollm-135m's parameters in the JAX
layout, keys ``group__name``) and ``batch.npz``.  This file imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
ARCH = "smollm-135m"
KNOBS = dict(kv_chunk=16, ssm_chunk=8)
N_MB = 4
# (pod, model) of the 8 ranks' meshes
MESHES = ((2, 2), (1, 2))


def load_tree(in_dir: Path):
    with np.load(in_dir / "tree.npz") as z:
        tree = {}
        for k in z.files:
            g, nm = k.split("__", 1)
            tree.setdefault(g, {})[nm] = z[k]
    return tree


def flat(tree, prefix=""):
    """{"a__b": numpy} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}__{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def setup(in_dir: Path):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model, ModelKnobs
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
    with np.load(in_dir / "batch.npz") as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    return cfg, model, params_from_jax(load_tree(in_dir), cfg, "cpu"), batch


def pipeline_grads(model, rules, params, batch):
    """(loss, gradients as whole tensors) of ``pipeline_loss``; every rank
    calls it."""
    from repro_torch.parallel.pipeline import pipeline_loss, place_pipeline
    placed = place_pipeline(model, params, rules)
    leaves = {g: {k: v.detach().requires_grad_(True) for k, v in sub.items()}
              for g, sub in placed.items()}
    flat_leaves = [v for sub in leaves.values() for v in sub.values()]
    loss = pipeline_loss(model, rules, leaves, batch, n_mb=N_MB)
    grads = torch.autograd.grad(loss, flat_leaves)
    it = iter(g.full_tensor() for g in grads)
    return float(loss), {g: {k: next(it) for k in sub}
                         for g, sub in leaves.items()}


def save(path: Path, cfg, loss, grads):
    from repro_torch.models.convert import params_to_jax
    np.savez(path, loss=np.asarray(loss), **flat(params_to_jax(grads, cfg)))


def _rank(rank, in_dir, out_dir):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    torch.set_num_threads(1)
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        cfg, model, params, batch = setup(in_dir)
        for pod, m in MESHES:
            mesh = make_host_mesh(model=m, pod=pod, device_type="cpu")
            rules = make_rules("cp").with_mesh(mesh)
            loss, grads = pipeline_grads(model, rules, params, batch)
            if rank == 0:
                save(out_dir / f"pod{pod}_model{m}.npz", cfg, loss, grads)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def world1(in_dir: Path, out_dir: Path):
    """(1, 1, 1) in a world-1 group beside ``Model.loss`` on the same
    microbatches, and the kernels' plain calls each took."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.step import _split, loss_and_grads
    from repro_torch.train.optim import tree_map
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store1",
                            rank=0, world_size=1)
    try:
        cfg, model, params, batch = setup(in_dir)
        rules = make_rules("cp").with_mesh(make_host_mesh(
            model=1, pod=1, device_type="cpu"))
        before = dict(ops.plain_calls)
        loss, grads = pipeline_grads(model, rules, params, batch)
        pipe_calls = {k: ops.plain_calls[k] - before[k] for k in before}
        save(out_dir / "world1_pipeline.npz", cfg, loss, grads)
        before = dict(ops.plain_calls)
        ref_loss, ref = 0.0, None
        for mb in _split(batch, N_MB):
            l, g = loss_and_grads(model, params, mb)
            ref_loss += float(l) / N_MB
            ref = g if ref is None else tree_map(torch.add, ref, g)
        ref_calls = {k: ops.plain_calls[k] - before[k] for k in before}
        save(out_dir / "world1_model_loss.npz", cfg, ref_loss,
             tree_map(lambda t: t / N_MB, ref))
        np.savez(out_dir / "world1_calls.npz",
                 **{f"pipe__{k}": v for k, v in pipe_calls.items()},
                 **{f"ref__{k}": v for k, v in ref_calls.items()})
    finally:
        dist.destroy_process_group()


def main(argv):
    in_dir, out_dir = argv
    mp.spawn(_rank, args=(in_dir, out_dir), nprocs=WORLD)
    world1(Path(in_dir), Path(out_dir))
    Path(out_dir, "done").write_text("ok")


if __name__ == "__main__":
    main(sys.argv[1:])
