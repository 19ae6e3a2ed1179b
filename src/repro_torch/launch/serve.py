"""End-to-end serving driver (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 8 --batch 4 --s-max 256 --max-new 16

Spins up the slot-based engine on a model with seeded random weights and
replays synthetic prompts (lengths 4-31, drawn as in the JAX driver),
reporting prefill time per request, decode time per step and aggregate
throughput.  Runs on the card unless ``--device cpu`` is given.

With ``--daemon``, instead drives simulated traffic through the always-on
tuning daemon (``repro_torch.serve.tuner.run_daemon_demo``): shape misses
open background studies, later shapes warm-start from the fleet store, and
an injected kernel-cost shift exercises the drift -> re-tune path without
serving ever stopping.  ``--device`` and ``--reduced`` apply to it too: the
one difference from the JAX driver, whose daemon always tunes the reduced
configuration, is that without ``--reduced`` the studies here run the
published widths.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.model import Model
from ..serve.engine import Engine, Request, ServeConfig


def main(argv=None):
    """Serve the synthetic requests and return the drained engine (results,
    timings, parameters); with ``--daemon``, return the daemon demo's
    summary."""
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
                    help="run the always-on tuning daemon demo instead")
    ap.add_argument("--rounds", type=int, default=4,
                    help="steady-state serving rounds (daemon demo)")
    ap.add_argument("--bank", default=None,
                    help="save the fleet statistics bank here (daemon demo)")
    ap.add_argument("--checkpoint", default=None,
                    help="daemon checkpoint path (daemon demo)")
    args = ap.parse_args(argv)

    if args.daemon:
        return _daemon_demo(args)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    eng = Engine(model, params, ServeConfig(
        batch_size=args.batch, s_max=args.s_max,
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed))
    for req in synthetic_requests(args.requests, cfg.vocab, args.seed,
                                  cfg.n_codebooks):
        eng.submit(req)
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


def synthetic_requests(n: int, vocab: int, seed: int, n_codebooks: int = 0):
    """The CLI's prompts: ``n`` requests of 4-31 tokens (each ``(k,
    n_codebooks)`` with codebooks) drawn from ``seed``, as the JAX
    package's ``launch/serve.py`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        k = int(rng.integers(4, 32))
        shape = (k, n_codebooks) if n_codebooks else (k,)
        out.append(Request(uid, rng.integers(0, vocab, size=shape)
                           .astype(np.int32)))
    return out


def _daemon_demo(args) -> dict:
    from ..serve.tuner import run_daemon_demo

    summary = run_daemon_demo(
        args.arch, rounds=args.rounds, checkpoint=args.checkpoint,
        bank_path=args.bank, log=print, device=args.device,
        reduced=args.reduced)
    r = summary["ratios"]
    print(f"hit ratio {r['hit_ratio']:.2f}, warm-start ratio "
          f"{r['warm_start_ratio']:.2f}, drift detected: "
          f"{summary['drift_detected']}, re-tunes: {summary['retunes']}, "
          f"served while re-tuning: {summary['served_while_retuning']}")
    for key, info in summary["second_tuned_serves"].items():
        print(f"  2nd tuned serve {key}: {info}")
    return summary


if __name__ == "__main__":
    main()
