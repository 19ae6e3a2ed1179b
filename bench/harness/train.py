"""A training cell: the program's train step (``train.step.make_train_step``
on ``Model.loss``, AdamW) driven for a window.

Set-up builds the one step object with its weights and optimizer state,
and drives it through the first ``CHECK_STEPS`` steps, which the check
reads: each step's loss, each leaf's first gradient as AdamW took it (its
first moment after one step over 1 - b1) and each leaf's change over those
steps (against the weights drawn again from the seed).  The window then
runs steps on fresh batches from where set-up left off, and a traced run
adds ``TRACE_STEPS`` more under the profiler.  Once the program's state is
freed, the reference runs the same first steps on the same batches.
"""

from __future__ import annotations

import time

import torch

from ..reference import shared as RS, train as RT
from . import program, trace, traffic as TR, weights
from .metrics import Run

# the steps the check compares, and the steps a traced run traces
CHECK_STEPS = 3
TRACE_STEPS = 2


def _opt(tr: dict):
    from repro_torch.train.optim import AdamWConfig
    return AdamWConfig(**tr["optimizer"])


def _program_readings(spec, tr, seed, device, params, opt_state, step):
    """Drive the first steps; returns (params, opt_state, readings)."""
    b1 = tr["optimizer"]["b1"]
    out = {"loss": [], "grad1": {}, "change": {}}
    for i in range(CHECK_STEPS):
        batch = TR.train_batch(tr, spec.vocab, seed, i, device)
        params, opt_state, metrics = step(params, opt_state, batch)
        out["loss"].append(float(metrics["loss"]))
        if i == 0:
            for g, sub in opt_state["m"].items():
                for n, m in sub.items():
                    out["grad1"][f"{g}/{n}"] = float(m.norm()) / (1 - b1)
    for g, sub in params.items():
        for n, p in sub.items():
            p0 = weights.draw(spec, seed, g, n, device)
            out["change"][f"{g}/{n}"] = float((p.float() - p0.float()).norm())
            del p0
    return params, opt_state, out


def _reference_readings(spec, tr, seed, device, prec=RS.F32, rows=None):
    params = weights.make(spec, seed, device, torch.float32)
    batches = [TR.train_batch(tr, spec.vocab, seed, i, device)
               for i in range(CHECK_STEPS)]
    return RT.steps(params, batches, spec, tr["optimizer"], tr["grad_accum"],
                    prec, rows)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start):
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step
    spec, tr = cell.spec, cell.traffic
    model = program.model(spec, tr["remat"], device)
    params = weights.make(spec, seed, device)
    opt_state = adamw_init(params)
    step = make_train_step(model, TrainConfig(grad_accum=tr["grad_accum"],
                                              optimizer=_opt(tr)))
    params, opt_state, prog = _program_readings(spec, tr, seed, device,
                                                params, opt_state, step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    k = CHECK_STEPS
    l0, n = program.launches(), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        batch = TR.train_batch(tr, spec.vocab, seed, k + n, device)
        params, opt_state, _ = step(params, opt_state, batch)
        n += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    run_ = Run("train", device.type, spec, tr, setup_s, window={
        "seconds": elapsed, "steps": n,
        "tokens": n * tr["batch"] * tr["seq"],
        "launches": program.launches() - l0})
    if traced:
        with trace.traced(device) as got:
            for i in range(TRACE_STEPS):
                batch = TR.train_batch(tr, spec.vocab, seed, k + n + i,
                                       device)
                params, opt_state, _ = step(params, opt_state, batch)
        run_.trace = got[0]
        run_.traced = {"steps": TRACE_STEPS}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del params, opt_state, step, model
    program.free(device)
    return run_, prog, peak, n


def check(cell, seed: int, device, prog: dict, controls: bool = False):
    """The compared numbers of the program's readings ``prog``; with
    ``controls`` also those of the reference in float8 (``control.*``) and
    of the reference with half of each microbatch's rows left out
    (``half_batch.*``), each read against the float32 reference, and each
    number's readings per step and by the median leaf (``details``)."""
    spec, tr = cell.spec, cell.traffic
    RS.exact_f32()
    ref = _reference_readings(spec, tr, seed, device)
    out = compare(prog, ref)
    if controls:
        out.update(details(prog, ref))
        ctl = _reference_readings(spec, tr, seed, device,
                                  RS.Precision("float8"))
        half = list(range(tr["batch"] // tr["grad_accum"] // 2))
        flt = _reference_readings(spec, tr, seed, device, rows=half)
        for name, got in (("control", ctl), ("half_batch", flt)):
            out.update({f"{name}.{k}": v for k, v in
                        {**compare(got, ref), **details(got, ref)}.items()})
    return out


def _moved(ref: dict) -> list:
    g = ref["grad1"]
    med = sorted(g.values())[len(g) // 2]
    return [k for k in g if g[k] >= 1e-3 * med]


def _gaps(a: dict, b: dict, names) -> dict:
    """Each leaf's gap of norms against max(its reference norm, the median
    leaf's)."""
    med = sorted(b[k] for k in names)[len(names) // 2]
    return {k: abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in names}


def details(prog: dict, ref: dict) -> dict:
    """The readings behind ``compare``'s numbers: each step's loss gap, the
    median leaf's change gap and the worst leaves' names."""
    out = {f"loss_gap.step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(prog["loss"], ref["loss"]))}
    for key, a, b, names in (
            ("grad", prog["grad1"], ref["grad1"], list(ref["grad1"])),
            ("change", prog["change"], ref["change"], _moved(ref))):
        gaps = _gaps(a, b, names)
        out[f"{key}_gap.worst_leaf"] = max(gaps, key=gaps.get)
        if key == "change":
            out["change_gap.median"] = sorted(gaps.values())[len(gaps) // 2]
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The readings a cell's limits may hold: the largest relative gap of a
    step's loss; of a leaf's first-gradient norm (the worst leaf, and the
    median leaf's) and (over the leaves the reference's first gradient
    moves: at least a thousandth of the median leaf's) of its change's
    norm, each against the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    g = _gaps(prog["grad1"], ref["grad1"], list(ref["grad1"]))
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(g.values()),
        "grad_gap.median": sorted(g.values())[len(g) // 2],
        "change_gap": max(_gaps(prog["change"], ref["change"],
                                _moved(ref)).values()),
    }
