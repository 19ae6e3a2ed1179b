"""The program under test, ``repro_torch``, as the benchmark drives it: its
model (configured by the spec's family), its model knobs, and its launch
counter.  Nothing else of the program is read."""

from __future__ import annotations

import torch

from .weights import DTYPES, layout


def model(spec, remat: str, device):
    """The program's ``Model`` of ``spec`` on ``device``, its weights'
    layout checked against the benchmark's."""
    from repro_torch.models.model import Model, ModelKnobs, spec_tree
    cfg = spec.family.arch_config(spec)
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
