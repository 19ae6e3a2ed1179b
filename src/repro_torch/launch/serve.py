"""End-to-end serving driver (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 8 --batch 4 --s-max 256 --max-new 16

Spins up the slot-based engine on a model with seeded random weights and
replays synthetic prompts (lengths 4-31, drawn as in the JAX driver),
reporting prefill time per request, decode time per step and aggregate
throughput.  Runs on the card unless ``--device cpu`` is given.  The JAX
driver's ``--daemon`` mode (the always-on tuning daemon) is not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.model import Model
from ..serve.engine import Engine, Request, ServeConfig


def main(argv=None) -> Engine:
    """Serve the synthetic requests; returns the drained engine (results,
    timings, parameters)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--daemon", action="store_true",
                    help="the tuning daemon demo: not ported yet")
    args = ap.parse_args(argv)
    if args.daemon:
        ap.error("--daemon (the always-on tuning daemon) is not ported to "
                 "repro_torch yet; run `python -m repro.launch.serve "
                 "--daemon` for the JAX version")

    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    eng = Engine(model, params, ServeConfig(
        batch_size=args.batch, s_max=args.s_max,
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed))
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        n = int(rng.integers(4, 32))
        eng.submit(Request(uid, rng.integers(0, cfg.vocab, size=(n,))
                           .astype(np.int32)))
    t0 = time.perf_counter()
    steps = 0
    while eng.queue or eng.active.any():
        eng.step()
        steps += 1
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in eng.results.values())
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    print(f"{args.requests} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {steps} engine steps) on "
          f"{eng.device}; prefill {1e3 * np.mean(pre):.2f} ms/request, "
          f"decode {1e3 * np.mean(dec):.2f} ms/step")
    for uid in sorted(eng.results)[:4]:
        print(f"  req {uid}: {eng.results[uid].tokens[:12]} ...")
    return eng


if __name__ == "__main__":
    main()
