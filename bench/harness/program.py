"""The program under test, ``repro_torch``, as the benchmark drives it: its
configuration, its model knobs, and its launch counter.  Nothing else of
the program is read."""

from __future__ import annotations

import torch

from .weights import DTYPES, layout


def arch_config(spec):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    moe = None
    if spec.n_experts:
        moe = MoEConfig(n_experts=spec.n_experts, top_k=spec.top_k,
                        d_ff_expert=spec.d_ff_expert,
                        capacity_factor=spec.capacity_factor)
    return ArchConfig(
        name=spec.name, family="moe" if moe else "dense",
        n_layers=spec.n_layers, d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff or spec.d_ff_expert,
        vocab=spec.vocab, pattern=("attn",),
        ffn_pattern=("moe",) if moe else ("dense",), moe=moe,
        d_head=spec.head_dim, rope_theta=spec.rope_theta,
        norm_eps=spec.norm_eps, tie_embeddings=spec.tie_embeddings)


def model(spec, remat: str, device):
    """The program's ``Model`` of ``spec`` on ``device``, its weights'
    layout checked against the benchmark's."""
    from repro_torch.models.model import Model, ModelKnobs, spec_tree
    cfg = arch_config(spec)
    ours = {g: {n: s for n, (s, _) in sub.items()}
            for g, sub in layout(spec).items()}
    theirs = {g: {n: tuple(s) for n, (s, _) in sub.items()}
              for g, sub in spec_tree(cfg).items()}
    if ours != theirs:
        raise RuntimeError(f"the program's parameter layout is not the "
                           f"benchmark's: {theirs} != {ours}")
    knobs = ModelKnobs(remat=remat,
                       param_dtype=DTYPES[spec.param_dtype],
                       compute_dtype=DTYPES[spec.compute_dtype],
                       logits_f32=spec.logits_dtype == "float32")
    return Model(cfg, knobs, device=device)


def launches() -> int:
    """Kernel launches the program has counted so far."""
    from repro_torch.kernels.ops import launches as counts
    return sum(counts.values())


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
