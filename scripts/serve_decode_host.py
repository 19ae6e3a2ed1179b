"""Host-clock serving times of the attention families on the card, to
compare two commits' model and engine code in one call.

Run from a checkout's root on a machine with a CUDA card:

    PYTHONPATH=src python3 scripts/serve_decode_host.py

Another commit is read the same way from its own unpacked tree
(``git archive <commit> | tar -x -C compare/parent``, then
``PYTHONPATH=compare/parent/src``): the script uses only
``models.model.spec_tree``/``Model``, ``serve.engine`` and
``launch.serve.synthetic_requests``, which the port has had since it
served deepseek-v2.  Run the two trees in turns (parent, change, change,
parent) and compare the least of each.

Each family is served at its published widths, cut in depth
(smollm-135m all 30 layers, phi3.5-moe 4 of 32, deepseek-v2 2 of 60;
``chip_smoke.py`` now cuts the last two to 2 and 1), with f32 weights drawn on the card from a seeded
CUDA generator by the tree's own ``spec_tree`` (the same draw in both
trees, whose specs agree for these families): 8 requests of 4-31 tokens,
4 slots, s_max 256, 16 new tokens, greedy.  It prints one line a family
with the prefill ms a request and the decode ms a step (host clock, the
mean over a run's steps), for each of 5 runs after one untimed run,
and the least; then one JSON line of them all.
"""

from __future__ import annotations

import json
import math
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models.model import Model, spec_tree
from repro_torch.serve.engine import Engine, ServeConfig

FAMILIES = (("smollm-135m", None), ("phi3.5-moe", 4), ("deepseek-v2", 2))
SERVE = dict(batch_size=4, s_max=256, max_new_tokens=16, seed=0)
REQUESTS = 8
RUNS = 5


def draw(cfg, seed=0):
    """f32 weights on the card: norms zero, embeddings N(0, 0.02^2),
    projections N(0, 1/fan_in), in ``spec_tree``'s sorted order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {}
    for g, sub in sorted(spec_tree(cfg).items()):
        for nm, (shape, fan) in sorted(sub.items()):
            if fan == 0.0:
                w = torch.zeros(shape, device="cuda")
            else:
                std = 0.02 if fan == -1 else 1.0 / math.sqrt(max(fan, 1))
                w = torch.randn(shape, generator=gen, device="cuda") * std
            params.setdefault(g, {})[nm] = w
    return params


def serve_once(model, params):
    eng = Engine(model, params, ServeConfig(**SERVE))
    for req in synthetic_requests(REQUESTS, model.cfg.vocab, 0):
        eng.submit(req)
    eng.run()
    torch.cuda.synchronize()
    return (1e3 * float(np.mean(eng.timings["prefill_s"])),
            1e3 * float(np.mean(eng.timings["decode_s"])),
            {u: r.tokens for u, r in eng.results.items()})


def main():
    out = {}
    for arch, layers in FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = replace(cfg, n_layers=layers)
        params = draw(cfg)
        model = Model(cfg, device="cuda")
        _, _, toks = serve_once(model, params)
        runs = [serve_once(model, params) for _ in range(RUNS)]
        if any(r[2] != toks for r in runs):
            raise AssertionError(f"{arch}: the tokens differ between runs")
        pre = [round(r[0], 3) for r in runs]
        dec = [round(r[1], 3) for r in runs]
        out[arch] = {"layers": cfg.n_layers, "prefill_ms_runs": pre,
                     "decode_ms_runs": dec, "prefill_ms": min(pre),
                     "decode_ms": min(dec)}
        print(f"{arch} ({cfg.n_layers} layers): prefill ms a request "
              f"{pre}, least {min(pre)}; decode ms a step {dec}, least "
              f"{min(dec)}", flush=True)
        del params, model
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
