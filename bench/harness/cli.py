"""One run of one cell: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

The run finds the cell in ``BENCHMARK.json``, refuses to run without the
CUDA devices the cell asks for, makes its weights and inputs from the
seed, sets up, measures for ``--seconds`` (with ``--trace 1`` it then
traces a short stretch), checks what the timed path produced against the
plain reference (``bench/limits/<cell>.json`` holds each compared number's
limit), and prints the result as the last line of standard output: the
end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``.  Each compared number, with its limit, is also the last
lines of standard error.  It prints no result, and exits with a code other
than 0, where the JAX package or JAX itself got loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

# what must not be loaded in the process that prints the result, compared
# with each loaded module's top-level name whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed place in the checkout (the
    program's own nvcc builds go to ``build/repro_torch``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")


def limits(name: str, root: Path) -> dict:
    path = root / "bench" / "limits" / f"{name}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def verdict(numbers: dict, lim: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: correct where each is at most its limit (none named, or
    one not read or not finite: not correct, its value null)."""
    checks = {}
    for k, v in lim.items():
        got = numbers.get(k)
        checks[k] = {"value": got if got is not None and math.isfinite(got)
                     else None, "limit": v}
    ok = bool(checks) and all(c["value"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def runner(kind: str):
    """The module that runs a traffic mix of ``kind``:
    ``bench/harness/<kind>.py`` with its ``run`` and ``check``."""
    import importlib
    mod = importlib.import_module(f"{__package__}.{kind}")
    if not (hasattr(mod, "run") and hasattr(mod, "check")):
        raise ValueError(f"no runner for traffic of kind {kind!r}")
    return mod


def execute(args, root: Path, device, t_start: float, chips: int = 1):
    """Run the cell on ``device``; returns the result's dict (its last key
    ``checks``)."""
    import torch
    from ..spec import cell_metrics, load_cell
    from .metrics import read_all
    cell = load_cell(args.workload, root)
    drive = runner(cell.traffic["kind"])
    run, readings, peak, attempted = drive.run(
        cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    numbers = drive.check(cell, args.seed, device, readings)
    ok, checks = verdict(numbers, limits(cell.name, root))
    metrics = read_all(cell_metrics(cell.name, root, bool(args.trace)), run,
                       root)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = checks
    return out


def main(argv, t_start: float) -> int:
    root = Path(__file__).resolve().parents[2]
    args = parse(argv)
    cache_env(root)
    sys.path.insert(0, str(root / "src"))
    import torch
    from ..spec import load_cell
    chips = load_cell(args.workload, root).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"bench: {args.workload} needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    out = execute(args, root, torch.device("cuda", 0), t_start, chips)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}, which the benchmark may not "
              f"load", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
