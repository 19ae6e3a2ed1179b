"""The rank side of ``tests/test_torch_sharded_serve.py``: one gloo group of
8 ranks on the CPU runs the port's serving engine under sharding rules and
writes what it got for the parent to hold against the JAX package.

    PYTHONPATH=src:tests python tests/torch_sharded_serve_ranks.py IN_DIR OUT_DIR

``IN_DIR`` holds ``tree_<arch>.npz`` (the reduced configurations'
parameters in the JAX layout, keys ``group__name``).  Besides the engine,
the cache's write rules run here on their own: ``write_block`` and
``layers.cache_update`` on sharded DTensors against the same writes on
whole tensors.  This file imports no JAX.
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
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from torch_expert_parallel_ranks import load_tree
from torch_sharded_ranks import KNOBS, rules_on

WORLD = 8
# (configuration, rule variant) pairs the engine runs under
CASES = (("smollm-135m", "cp"), ("smollm-135m", "tp"), ("smollm-135m", "dp"),
         ("xlstm-125m", "cp"), ("deepseek-v2", "cp"),
         ("jamba-v0.1-52b", "tp"), ("musicgen-large", "cp"))
SERVE = dict(batch_size=4, s_max=64, max_new_tokens=6)
# prompt lengths: within KNOBS' ssm_chunk of 8 or multiples of it (the
# reference's chunked_scan refuses any other)
PROMPTS = (5, 8, 16, 7, 3)
# (global shape, placements on the (2, 4) mesh, block start) of the
# write-rule cases; S0 = Shard(0), R = Replicate
WRITE_CASES = (
    ((2, 4, 16, 2, 8), ("S1", "S2"), (1, 2, 0, 0, 0)),
    ((2, 4, 16, 4, 8), ("S1", "S3"), (0, 3, 0, 0, 0)),
    ((2, 8, 16, 2, 8), ("S1", "S1"), (0, 5, 0, 0, 0)),
    ((2, 4, 6, 8), ("R", "S3"), (1, 0, 0, 0)),
)


# the functional collectives DTensor's redistributions run
COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
               "all_to_all_single", "shard_dim_alltoall", "broadcast")


class CommBytes(TorchDispatchMode):
    """Counts the collectives run under it and the bytes of their inputs on
    this rank, by op (DTensor's redistributions run functional
    collectives on the local tensors)."""

    def __init__(self):
        super().__init__()
        self.calls, self.bytes = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # a mode runs before DTensor: step aside, so that DTensor's op runs
        # and its collectives come back here on local tensors
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            name = func._opname
            ts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            n = sum(t.numel() * t.element_size() for t in ts
                    if isinstance(t, torch.Tensor))
            self.calls[name] = self.calls.get(name, 0) + 1
            self.bytes[name] = self.bytes.get(name, 0) + n
        return func(*args, **(kwargs or {}))


def prompts(vocab: int, n_codebooks: int = 0):
    """The requests' prompts: (n,) tokens, or (n, ncb) with codebooks."""
    rng = np.random.default_rng(11)
    tail = (n_codebooks,) if n_codebooks else ()
    return [rng.integers(0, vocab, (n,) + tail).astype(np.int32)
            for n in PROMPTS]


def run_engine(arch, variant, in_dir):
    """(tokens per request, the engine's cache gathered) of the port's
    engine under ``variant`` on (2, 4) (None: one device)."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import Model, ModelKnobs, map_cache
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, ModelKnobs(**KNOBS), device="cpu")
    params = params_from_jax(load_tree(in_dir / f"tree_{arch}.npz"), cfg,
                             "cpu")
    rules = None if variant is None else rules_on(4, variant)
    eng = Engine(model, params, ServeConfig(**SERVE), rules=rules)
    for uid, p in enumerate(prompts(cfg.vocab, cfg.n_codebooks)):
        eng.submit(Request(uid, p))
    from repro_torch.models import layers, ssm
    comm = CommBytes()
    parts = {(layers, "decode_attention"): CommBytes(),
             (layers, "cache_update"): CommBytes(),
             (ssm, "causal_conv"): CommBytes()}
    inner = model.decode_step

    def counted(*a, **kw):
        with comm:
            return inner(*a, **kw)

    def part(key, fn):
        def wrapped(*a, **kw):
            with parts[key]:
                return fn(*a, **kw)
        return wrapped
    model.decode_step = counted
    saved = {key: getattr(*key) for key in parts}
    for key, fn in saved.items():
        setattr(*key, part(key, fn))
    try:
        res = eng.run()
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
    steps = len(eng.timings["decode_s"])
    local = sum(t.to_local().numel() * t.element_size()
                for t in _leaves(eng.cache))
    cache = map_cache(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                      else t, eng.cache)
    whole = sum(t.numel() * t.element_size() for t in _leaves(cache))
    stats = {"decode_steps": steps, "cache_bytes": whole,
             "cache_bytes_local": local}
    for name, c in (("step", comm),) + tuple(
            (key[1], c) for key, c in parts.items()):
        stats[name] = {k: {"calls": c.calls[k] / steps,
                           "bytes": c.bytes[k] / steps}
                       for k in c.calls if k in COLLECTIVES}
    return {uid: r.tokens for uid, r in res.items()}, cache, stats


def _leaves(cache):
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for sub in cache for t in _leaves(sub)]


def _flat_cache(cache, prefix="c"):
    if isinstance(cache, torch.Tensor):
        return {prefix: cache.numpy()}
    out = {}
    for i, sub in enumerate(cache):
        out.update(_flat_cache(sub, f"{prefix}_{i}"))
    return out


# ---------------------------------------------------------------------------
# the cases, each run by every rank in order
# ---------------------------------------------------------------------------

def case_writes(rank, in_dir, out_dir):
    """``write_block`` (a block into a sharded cache, as the engine's
    splice and the prefill's store write it) and ``cache_update`` (one
    position a row, rows at different positions) on sharded DTensors
    against the same writes on whole tensors: max abs error each."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import write_block
    mesh = rules_on(4, "cp").mesh
    pl = {"R": Replicate()}
    got = {}
    gen = torch.Generator().manual_seed(0)
    for n, (shape, places, start) in enumerate(WRITE_CASES):
        places = [pl.get(c) or Shard(int(c[1:])) for c in places]
        big = torch.randn(shape, generator=gen)
        one = torch.randn((1, 1) + shape[2:], generator=gen)
        want = big.clone()
        write_block(want, one, start)
        dt = distribute_tensor(big, mesh, places, src_data_rank=None)
        write_block(dt, distribute_tensor(one, mesh, [Replicate()] * 2),
                    start)
        got[f"block {n}"] = float((dt.full_tensor() - want).abs().max())
        moved = float((dt.full_tensor() - big).abs().max())
        got[f"block {n} wrote"] = moved > 0
        if len(shape) == 5:
            # per-row positions across the sequence shards
            c = big[0].clone()
            new = torch.randn((shape[1], 1) + shape[3:], generator=gen)
            t = torch.arange(shape[1]) * 5 % shape[2]
            want = c.clone()
            layers.cache_update(want, new, t)
            dc = distribute_tensor(c, mesh, [Shard(p.dim - 1) if p.is_shard()
                                             else p for p in places],
                                   src_data_rank=None)
            layers.cache_update(dc, distribute_tensor(new, mesh, [
                Shard(0), Replicate()]), t)
            got[f"rows {n}"] = float((dc.full_tensor() - want).abs().max())
    if rank == 0:
        (out_dir / "writes.json").write_text(json.dumps(got))


def case_engines(rank, in_dir, out_dir):
    """The engine under each case's rules: the tokens, the cache gathered,
    and rank 0's collectives a decode step (calls and input bytes by op)
    beside the cache's bytes."""
    tokens, comm = {}, {}
    for arch, variant in CASES:
        toks, cache, stats = run_engine(arch, variant, in_dir)
        tokens[f"{arch} {variant}"] = toks
        comm[f"{arch} {variant}"] = stats
        if rank == 0:
            np.savez(out_dir / f"cache_{arch} {variant}.npz",
                     **_flat_cache(cache))
    if rank == 0:
        (out_dir / "tokens.json").write_text(json.dumps(tokens))
        (out_dir / "comm.json").write_text(json.dumps(comm, indent=1))


CASES_RUN = (case_writes, case_engines)


def _rank(rank, in_dir, out_dir):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        for case in CASES_RUN:
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
