"""Cell builder: (arch x shape x mesh x sharding-variant x knobs) -> a step
function and its arguments, fake tensors placed on the mesh (port of
``repro.launch.cells``).  Shared by the dry-run and its configuration
search, so every consumer traces the SAME programs.

The reference's arguments are ``ShapeDtypeStruct``s with input shardings,
which XLA lowers.  Here they are fake tensors (``FakeTensorMode``: sizes,
no data), each placed by its sharding as a DTensor on the mesh (each rank's
local shape), the mesh a ``DeviceMesh`` over the ``"fake"`` process group
that the dry-run opens (``launch/mesh.py``).  There is nothing to lower:
``Cell.trace`` runs ``fn`` once under the counters of ``trace_cost.py``.

- train: ``make_train_step(model, tc, rules=...)`` on the parameters,
  AdamW state and the global host batch (the step places each microbatch
  itself, as on the card);
- prefill: ``Model.prefill`` of the placed batch into a ``seq_len`` cache;
- decode: ``Model.decode_step`` of one placed token per row against a
  placed ``seq_len`` cache, the positions a (B,) tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import SHAPES, get_config
from ..configs.base import ArchConfig, Shape
from ..models.model import Model, ModelKnobs, map_cache
from ..parallel.sharding import (NamedSharding, P, ShardingRules, axis_rules,
                                 distribute, local_shape, make_rules,
                                 map_axes, place)
from ..train.optim import adamw_init
from ..train.step import (TrainConfig, make_train_step, opt_shardings,
                          param_shardings)
from .trace_cost import Trace, trace

DRYRUN_KNOBS = ModelKnobs(kv_chunk=512, ssm_chunk=256, remat="full",
                          param_dtype=torch.bfloat16,
                          compute_dtype=torch.bfloat16)

# baseline microbatching: 4 grad-accumulation slices (a tuning knob; the
# baseline just needs to FIT)
DRYRUN_TRAIN = TrainConfig(grad_accum=4)


@dataclass
class Cell:
    arch: str
    shape: str
    variant: str
    fn: Callable
    args: Tuple            # fake tensors (DTensors where placed)
    in_shardings: Tuple
    donate: Tuple[int, ...]
    cfg: ArchConfig
    model: Model
    rules: ShardingRules

    def trace(self) -> Tuple[Any, Trace]:
        """Run ``fn`` once on the fake arguments under the counters: (its
        output, the trace)."""
        return trace(self.fn, *self.args)

    def argument_bytes(self) -> Dict[str, int]:
        """Per-device bytes of each argument as its sharding places it (the
        reference's ``memory_analysis().argument_size_in_bytes``, split by
        argument)."""
        out = {}
        for i, (arg, sh) in enumerate(zip(self.args, self.in_shardings)):
            out[_ARG_NAMES[self.kind][i]] = _placed_bytes(arg, sh)
        return out

    @property
    def kind(self) -> str:
        return SHAPES[self.shape].kind


_ARG_NAMES = {"train": ("params", "opt_state", "batch"),
              "prefill": ("params", "batch"),
              "decode": ("params", "cache", "t", "batch")}


def _placed_bytes(tree, shardings) -> int:
    """Bytes of this rank's shards of ``tree`` under the same-structure
    ``shardings`` tree (a leaf NamedSharding applies to a whole
    subtree)."""
    if isinstance(shardings, NamedSharding):
        if isinstance(tree, torch.Tensor):
            shape = local_shape(tree.shape, shardings.mesh,
                                shardings.placements)
            return math.prod(shape) * tree.element_size()
        leaves = tree.values() if isinstance(tree, dict) else tree
        return sum(_placed_bytes(t, shardings) for t in leaves)
    if isinstance(tree, dict):
        return sum(_placed_bytes(tree[k], shardings[k]) for k in tree)
    return sum(_placed_bytes(t, s) for t, s in zip(tree, shardings))


def batch_sds(cfg: ArchConfig, shape: Shape, knobs: ModelKnobs):
    """(fake host tensors, logical axes) for a train/prefill batch; call
    under a ``FakeTensorMode``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(shp, dtype=i32):
        return torch.empty(shp, dtype=dtype)

    if cfg.n_patches:
        S_text = S - cfg.n_patches
        t = {"tokens": sds((B, S_text)), "labels": sds((B, S_text)),
             "patches": sds((B, cfg.n_patches, cfg.d_model),
                            knobs.compute_dtype)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "patches": ("batch", None, None)}
    elif cfg.n_codebooks:
        t = {"tokens": sds((B, S, cfg.n_codebooks)),
             "labels": sds((B, S, cfg.n_codebooks))}
        axes = {"tokens": ("batch", "seq", None),
                "labels": ("batch", "seq", None)}
    else:
        t = {"tokens": sds((B, S)), "labels": sds((B, S))}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        t.pop("labels")
        axes.pop("labels")
    return t, axes


def _ns(rules: ShardingRules, axes_tree, tree):
    def one(ax, t):
        return NamedSharding(rules.mesh, rules.spec(*ax, dims=t.shape))
    return map_axes(one, axes_tree, tree)


def build_cell(arch: str, shape_name: str, mesh, *,
               variant: str = "cp", knobs: Optional[ModelKnobs] = None,
               tc: Optional[TrainConfig] = None) -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    knobs = knobs or DRYRUN_KNOBS
    if tc is None:
        # >50B-param archs need deeper accumulation to fit activations;
        # bf16 grad accumulation is their default (the reference's)
        big = cfg.param_counts()["total"] > 50e9
        tc = TrainConfig(grad_accum=8, accum_dtype=torch.bfloat16) if big \
            else DRYRUN_TRAIN
    rules = make_rules(variant).with_mesh(mesh)
    model = Model(cfg, knobs, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        host = model.init(torch.Generator())
        p_sh = param_shardings(model, rules)
        params = place(host, p_sh)

        if shape.kind == "train":
            o_sh = opt_shardings(model, rules)
            o = adamw_init(host)
            opt = {"m": place(o["m"], o_sh["m"]),
                   "v": place(o["v"], o_sh["v"]),
                   "step": distribute(o["step"], o_sh["step"])}
            batch, b_axes = batch_sds(cfg, shape, knobs)
            b_sh = _ns(rules, b_axes, batch)
            fn = make_train_step(model, tc, rules=rules)
            return Cell(arch, shape_name, variant, fn, (params, opt, batch),
                        (p_sh, o_sh, b_sh), (0, 1), cfg, model, rules)

        if shape.kind == "prefill":
            host_b, b_axes = batch_sds(cfg, shape, knobs)
            b_sh = _ns(rules, b_axes, host_b)
            batch = place(host_b, b_sh)

            def prefill_fn(params, batch):
                with axis_rules(rules):
                    return model.prefill(params, batch, shape.seq_len)

            return Cell(arch, shape_name, variant, prefill_fn,
                        (params, batch), (p_sh, b_sh), (), cfg, model, rules)

        # decode: one new token against a seq_len cache
        B, S = shape.global_batch, shape.seq_len
        cache = model.init_cache(B, S, rules=rules)
        c_sh = map_cache(lambda t: NamedSharding(mesh, P(*_spec_of(t))),
                         cache)
        t = torch.empty((B,), dtype=torch.int32)
        t_sh = NamedSharding(mesh, rules.spec("batch", dims=(B,)))
        trail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        tok = {"tokens": torch.empty((B, 1) + trail, dtype=torch.int32)}
        tok_ax = {"tokens": ("batch", None) + ((None,) if trail else ())}
        tok_sh = _ns(rules, tok_ax, tok)
        tokens = place(tok, tok_sh)

        def serve_step(params, cache, t, batch):
            with axis_rules(rules):
                return model.decode_step(params, cache, t, batch)

        return Cell(arch, shape_name, variant, serve_step,
                    (params, cache, t, tokens), (p_sh, c_sh, t_sh, tok_sh),
                    (1,), cfg, model, rules)


def _spec_of(t) -> tuple:
    """A placed DTensor's spec (mesh axis names per tensor dim, major
    first in mesh order)."""
    names = t.device_mesh.mesh_dim_names
    entries = [[] for _ in range(t.ndim)]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            entries[p.dim].append(names[i])
    out = [None if not e else (e[0] if len(e) == 1 else tuple(e))
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def model_flops(cfg: ArchConfig, shape: Shape) -> float:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference), N = active body
    params + embed/head matmul params, D = tokens processed per step."""
    pc = cfg.param_counts()
    n_active = pc["body_active"] + pc["embed"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch
