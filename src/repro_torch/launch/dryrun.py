"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

Traces every runnable (architecture x input shape) cell on the single-pod
16x16 mesh AND the 2x16x16 multi-pod mesh, without a device: the step runs
once on fake tensors (``launch/cells.py``) over a process group of the
``"fake"`` backend, this process rank 0 of 256 or 512 (``launch/mesh.py``
``fake_world``, opened here for each cell and destroyed after it; importing
this module opens nothing).  Each cell's record holds the traced rank's
flops, bytes, collectives, ops and live memory (``trace_cost.py``), its
roofline terms against an H100's peaks, and whether its peak fits the
card's memory; one JSON file per cell under ``--out``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --all --variant tp --suffix _tp
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from ..configs import SHAPES, all_cells
from ..kernels.cost import CARD_MEMORY_BYTES, CARD_NAME
from .cells import build_cell, model_flops
from .mesh import fake_world, make_production_mesh, production_size
from .trace_cost import op_census, roofline_terms

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "dryrun_out"


def run_cell(arch: str, shape: str, *, multi_pod: bool, variant: str = "cp",
             knobs=None, tc=None, verbose: bool = True) -> dict:
    with fake_world(production_size(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh, variant=variant, knobs=knobs,
                          tc=tc)
        build_s = time.perf_counter() - t0
        _, tr = cell.trace()
        args = cell.argument_bytes()
        n_chips = mesh.size()
        dims = list(mesh.shape)
        axes = list(mesh.mesh_dim_names)
    return record(arch, shape, variant, dims, axes, n_chips, build_s, tr,
                  args, model_flops(cell.cfg, SHAPES[shape]), verbose)


def record(arch, shape, variant, dims, axes, n_chips, build_s, tr, args,
           mf, verbose=True) -> dict:
    """A cell's JSON record from its trace (``Cell.trace``)."""
    c = tr.cost
    coll = tr.collectives
    terms = roofline_terms(c.flops, c.bytes, coll.total_bytes)
    peak = tr.peak_bytes
    rec = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": dims, "axes": axes, "chips": n_chips,
        "build_s": round(build_s, 2), "trace_s": round(tr.trace_s, 2),
        "memory": {
            # this rank's share of each argument as its sharding places it
            "argument_bytes": sum(args.values()),
            "argument_bytes_by_arg": args,
            "output_bytes": tr.output_bytes,
            # the live storages' peak over the trace, arguments included
            # (the step's host batch whole on every rank, as the port's
            # step takes it)
            "peak_bytes": peak,
            "live_est_bytes": peak,
            "card": CARD_NAME,
            "card_memory_bytes": CARD_MEMORY_BYTES,
            "fits": bool(peak <= CARD_MEMORY_BYTES),
        },
        # the traced rank's counts, and the global program's (x chips:
        # every rank of an SPMD step does rank 0's work)
        "jaxpr_cost": {"flops_per_dev": c.flops, "bytes_per_dev": c.bytes,
                       "dot_flops_per_dev": c.dot_flops,
                       "flops_global": c.flops * n_chips,
                       "bytes_global": c.bytes * n_chips,
                       "dot_flops_global": c.dot_flops * n_chips},
        "kernels": {k: {"calls": tr.kernels.calls[k],
                        "bytes": tr.kernels.bytes[k],
                        "flops": tr.kernels.flops[k]}
                    for k in sorted(tr.kernels.calls)},
        "collectives": {
            "total_bytes_per_dev": coll.total_bytes,
            "by_kind": coll.bytes_by_kind,
            "counts": coll.count_by_kind,
        },
        "ops": op_census(tr),
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (c.flops * n_chips) if c.flops else 0.0),
    }
    if verbose:
        gb = 1 << 30
        print(f"[{arch} x {shape} x {variant} @ {'x'.join(map(str, dims))}]"
              f" build {build_s:.1f}s trace {tr.trace_s:.1f}s")
        print(f"  mem/dev: args {rec['memory']['argument_bytes'] / gb:.2f} "
              f"GiB peak {peak / gb:.2f} GiB (fits "
              f"{CARD_MEMORY_BYTES / gb:.2f} GiB: {rec['memory']['fits']})")
        print(f"  flops/dev {terms['flops_per_dev']:.3e}"
              f"  bytes/dev {terms['bytes_per_dev']:.3e}"
              f"  coll bytes/dev {terms['collective_bytes_per_dev']:.3e}")
        print(f"  roofline s: compute {terms['compute_s']:.4f}"
              f" memory {terms['memory_s']:.4f}"
              f" collective {terms['collective_s']:.4f}"
              f"  -> {terms['bound']}-bound;"
              f" useful-flops ratio {rec['useful_flops_ratio']:.3f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--variant", default="cp")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--suffix", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'multi' if mp else 'single'}" \
                  f"{args.suffix}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               variant=args.variant)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:  # a failure here is a bug in the system
                failures.append((tag, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("\ndry-run complete: all cells traced.")


if __name__ == "__main__":
    main()
