"""The rank side of ``tests/test_torch_jaxdist.py``: one gloo group of 8
ranks on the CPU, a (2, 2, 2) mesh, runs ``repro_torch.jaxdist`` on the
parent's inputs and writes the gathered results.

    PYTHONPATH=src python tests/torch_jaxdist_ranks.py IN_DIR OUT_DIR

``IN_DIR/inputs.npz`` holds A, B (the 3D product), Am (the tall-skinny
panel) and SPD (the Cholesky input).  This file imports no JAX.
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
BLOCK = 8                       # the reference test's base-case block


def _rank(rank, in_dir, out_dir):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.jaxdist import (cholesky_3d, make_3d_mesh,
                                         matmul_3d, tsqr)
        from repro_torch.kernels import ops
        mesh = make_3d_mesh(2, device="cpu")
        with np.load(Path(in_dir) / "inputs.npz") as z:
            x = {k: torch.from_numpy(z[k]) for k in z.files}
        ops.plain_calls["matmul"] = 0
        c = matmul_3d(x["A"], x["B"], mesh)
        q, r = tsqr(x["Am"], mesh, "x")
        l, linv = cholesky_3d(x["SPD"], mesh, block=BLOCK)
        out = {"C": c, "Q": q, "R": r, "L": l, "Linv": linv}
        placements = {k: str(t.placements) for k, t in out.items()}
        out = {k: t.full_tensor().numpy() for k, t in out.items()}
        calls = ops.plain_calls["matmul"]
        got = [None] * WORLD
        dist.all_gather_object(got, calls)
        if rank == 0:
            np.savez(Path(out_dir) / "jaxdist.npz", calls=np.asarray(got),
                     placements=np.asarray(
                         [f"{k} {v}" for k, v in sorted(placements.items())]),
                     **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv):
    in_dir, out_dir = argv
    mp.spawn(_rank, args=(in_dir, out_dir), nprocs=WORLD)
    Path(out_dir, "done").write_text("ok")


if __name__ == "__main__":
    main(sys.argv[1:])
