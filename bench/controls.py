"""The readings a cell's limits are set from: for each seed, the numbers
``correct`` compares for the program, and for its control (the reference
computed in float8 in the program's place) and, in a training cell, for
the reference with half of each microbatch's rows left out.

    python3 bench/controls.py --workload <cell> --seconds <s> --seeds 1 2 3

runs every seed in one process on the card (the control only on the first
``--control-seeds``) (``--device cpu``: the
program's plain versions, for a test) and prints one JSON line a seed,
then one line with each number's largest reading over the seeds.  A
training cell's readings come from its set-up's first steps, so its window
may be 0 seconds; a serving cell needs a window long enough to complete
the mix's longest requests.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(workload: str, seeds, seconds: float, device, root: Path,
             control_seeds: int):
    import torch
    from bench.harness.cli import runner as runner_of
    from bench.spec import load_cell
    cell = load_cell(workload, root)
    drive = runner_of(cell.traffic["kind"])
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        _, got, _, _ = drive.run(cell, seed, seconds, False, device, t0)
        row = drive.check(cell, seed, device, got,
                           controls=i < control_seeds)
        row["seed"] = seed
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the first this many seeds also read the control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    rows = readings(args.workload, args.seeds, args.seconds,
                    torch.device(args.device), root, args.control_seeds)
    keys = [k for k in rows[0] if k not in ("seed", "seconds")
            and not k.endswith("worst_leaf")]
    print(json.dumps({
        "max": {k: max(r[k] for r in rows if k in r) for k in keys},
        "min": {k: min(r[k] for r in rows if k in r) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
