"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --model-axis 2 --variant cp

Runs the full stack: config -> model -> train step (sharded when a mesh is
requested) -> synthetic data pipeline -> checkpoint/restart, on the card
unless ``--device cpu`` is given.  Auto-resumes from the latest checkpoint
in --ckpt-dir (fault tolerance: kill it at any step and rerun the same
command); the checkpoints are in the JAX package's format, so either
launcher resumes the other's, and a sharded run restores onto whatever mesh
it runs on (elastic).

``--model-axis N`` trains on the reference's (data, model) host mesh with a
model axis of N (``launch/mesh.py``) under the rules of ``--variant``.  It
uses the process group if one is initialized, else initializes one from
``torchrun``'s environment (NCCL on the card, gloo with ``--device cpu``,
one card a rank: ``LOCAL_RANK``), else a group of one rank, which it
destroys at the end.  ``--model-axis 0`` is the one-device path.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..configs.base import Shape
from ..models.model import Model, ModelKnobs, spec_tree
from ..parallel.sharding import gather, make_rules, place
from ..train import checkpoint as ckpt
from ..train.data import DataConfig, batch_iterator
from ..train.optim import AdamWConfig, adamw_init
from ..train.step import (TrainConfig, make_train_step, opt_shardings,
                          param_shardings)
from .mesh import make_host_mesh


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=0,
                    help="use a (data, model) host mesh with this model size")
    ap.add_argument("--variant", default="cp")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def init_process_group(device: str) -> bool:
    """The process group for ``--model-axis``: the one initialized, else
    one from ``torchrun``'s environment, else one rank's.  True where this
    call initialized it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def build(args: argparse.Namespace, rules=None):
    """(cfg, shape, model, step_fn) of the parsed command: the reference
    launcher's knobs (KV chunk min(64, seq), SSM chunk min(32, seq), the
    default remat) and AdamW (warmup 10, decay over --steps); the step
    sharded under ``rules`` where they are given."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = Shape("cli", args.seq, args.batch, "train")
    knobs = ModelKnobs(kv_chunk=min(64, args.seq),
                       ssm_chunk=min(32, args.seq))
    device = args.device
    if rules is not None and device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = Model(cfg, knobs, device=device)
    return cfg, shape, model, make_train_step(model, train_config(args),
                                              rules=rules)


def train_config(args: argparse.Namespace) -> TrainConfig:
    """The step's microbatches and AdamW (warmup 10, decay over
    --steps)."""
    return TrainConfig(grad_accum=args.grad_accum,
                       optimizer=AdamWConfig(lr=args.lr, warmup=10,
                                             decay_steps=args.steps))


def main(argv=None) -> dict:
    """Train and return {"params", "opt", "start", "history"}: the final
    parameters and AdamW state (whole tensors, gathered on every rank under
    a mesh), the step resumed from (0 for a fresh run) and per step run
    {"step", "loss", "grad_norm", "lr", "host_ms"} (host clock from the
    batch's draw to the loss on the host)."""
    args = parse(argv)
    owned = bool(args.model_axis) and init_process_group(args.device)
    try:
        return _train(args)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> dict:
    rules = None
    if args.model_axis:
        n = dist.get_world_size()
        if n % args.model_axis:
            raise SystemExit(f"--model-axis {args.model_axis} does not "
                             f"divide the world of {n} ranks")
        mesh = make_host_mesh(args.model_axis, device_type=args.device)
        rules = make_rules(args.variant).with_mesh(mesh)
    cfg, shape, model, step_fn = build(args, rules)
    say = print if rules is None or dist.get_rank() == 0 else \
        (lambda *a: None)
    shardings = None if rules is None else {
        "params": param_shardings(model, rules),
        "opt": opt_shardings(model, rules)}

    start = 0
    if args.ckpt_dir and (latest := ckpt.latest_step(args.ckpt_dir)) \
            is not None:
        params_like = {g: {nm: torch.empty(shp, device="meta")
                           for nm, (shp, _) in sub.items()}
                       for g, sub in spec_tree(cfg).items()}
        like = {"params": params_like, "opt": adamw_init(params_like)}
        tree, man = ckpt.restore(args.ckpt_dir, latest, like, cfg=cfg,
                                 device=model.device, shardings=shardings)
        params, opt_state = tree["params"], tree["opt"]
        start = man["step"]
        say(f"resumed from step {start}")
    else:
        params = model.init(torch.Generator().manual_seed(args.seed))
        opt_state = adamw_init(params)
        if shardings is not None:
            params = place(params, shardings["params"])
            opt_state = place(opt_state, shardings["opt"])

    it = batch_iterator(cfg, shape, DataConfig(seed=args.seed),
                        start_step=start)
    history = []
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        if rules is None:       # the sharded step places the batch itself
            batch = {k: v.to(model.device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = metrics["loss"].item()
        history.append({"step": i + 1, "loss": loss,
                        "grad_norm": metrics["grad_norm"].item(),
                        "lr": metrics["lr"].item(),
                        "host_ms": 1e3 * (time.perf_counter() - t_step)})
        if (i + 1) % args.log_every == 0 or i == start:
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            say(f"step {i + 1:5d}  loss {loss:.4f}  "
                f"gnorm {history[-1]['grad_norm']:.3f}  "
                f"{dt * 1e3:.0f} ms/step")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1,
                      {"params": params, "opt": opt_state}, cfg=cfg, keep=3)
    say("done:", args.steps, "steps")
    return {"params": gather(params), "opt": gather(opt_state),
            "start": start, "history": history}


if __name__ == "__main__":
    main()
