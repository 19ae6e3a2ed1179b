"""End-to-end training launcher (port of ``repro.launch.train`` on one
device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu

Runs the full stack: config -> model -> train step -> synthetic data
pipeline -> checkpoint/restart, on the card unless ``--device cpu`` is
given.  Auto-resumes from the latest checkpoint in --ckpt-dir (fault
tolerance: kill it at any step and rerun the same command); the
checkpoints are in the JAX package's format, so either launcher resumes the
other's.  ``--model-axis`` above 0 (the reference's (data, model) mesh) is
refused: it waits for the multi-GPU port.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..configs.base import Shape
from ..models.model import Model, ModelKnobs, spec_tree
from ..train import checkpoint as ckpt
from ..train.data import DataConfig, batch_iterator
from ..train.optim import AdamWConfig, adamw_init
from ..train.step import TrainConfig, make_train_step


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
                    help="a (data, model) mesh: waits for the multi-GPU "
                         "port, refused above 0")
    ap.add_argument("--variant", default="cp")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.model_axis:
        ap.error(f"--model-axis {args.model_axis}: the (data, model) mesh "
                 f"waits for the multi-GPU port; this launcher trains on one "
                 f"device (--model-axis 0)")
    return args


def build(args: argparse.Namespace):
    """(cfg, shape, model, step_fn) of the parsed command: the reference
    launcher's knobs (KV chunk min(64, seq), SSM chunk min(32, seq), the
    default remat) and AdamW (warmup 10, decay over --steps)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = Shape("cli", args.seq, args.batch, "train")
    knobs = ModelKnobs(kv_chunk=min(64, args.seq),
                       ssm_chunk=min(32, args.seq))
    model = Model(cfg, knobs, device=args.device)
    tc = TrainConfig(grad_accum=args.grad_accum,
                     optimizer=AdamWConfig(lr=args.lr, warmup=10,
                                           decay_steps=args.steps))
    return cfg, shape, model, make_train_step(model, tc)


def main(argv=None) -> dict:
    """Train and return {"params", "opt", "start", "history"}: the final
    parameters and AdamW state, the step resumed from (0 for a fresh run)
    and per step run {"step", "loss", "grad_norm", "lr", "host_ms"} (host
    clock from the batch's draw to the loss on the host)."""
    args = parse(argv)
    cfg, shape, model, step_fn = build(args)

    start = 0
    if args.ckpt_dir and (latest := ckpt.latest_step(args.ckpt_dir)) \
            is not None:
        params_like = {g: {nm: torch.empty(shp, device="meta")
                           for nm, (shp, _) in sub.items()}
                       for g, sub in spec_tree(cfg).items()}
        like = {"params": params_like, "opt": adamw_init(params_like)}
        tree, man = ckpt.restore(args.ckpt_dir, latest, like, cfg=cfg,
                                 device=model.device)
        params, opt_state = tree["params"], tree["opt"]
        start = man["step"]
        print(f"resumed from step {start}")
    else:
        params = model.init(torch.Generator().manual_seed(args.seed))
        opt_state = adamw_init(params)

    it = batch_iterator(cfg, shape, DataConfig(seed=args.seed),
                        start_step=start)
    history = []
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = metrics["loss"].item()
        history.append({"step": i + 1, "loss": loss,
                        "grad_norm": metrics["grad_norm"].item(),
                        "lr": metrics["lr"].item(),
                        "host_ms": 1e3 * (time.perf_counter() - t_step)})
        if (i + 1) % args.log_every == 0 or i == start:
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            print(f"step {i + 1:5d}  loss {loss:.4f}  "
                  f"gnorm {history[-1]['grad_norm']:.3f}  "
                  f"{dt * 1e3:.0f} ms/step")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1,
                      {"params": params, "opt": opt_state}, cfg=cfg, keep=3)
    print("done:", args.steps, "steps")
    return {"params": params, "opt": opt_state, "start": start,
            "history": history}


if __name__ == "__main__":
    main()
