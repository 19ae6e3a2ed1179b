"""The port's dry-run dot flops beside the JAX package's, one reduced train
cell a family, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dryrun_dot_flops.py

Each configuration's reduced cell (8 x 32 tokens, grad accumulation 4, the
dry-run's knobs, cp rules on a (2, 4) mesh): JAX's ``cost_of(fn,
*args).dot_flops`` of the global step (its jaxpr on 8 virtual devices,
nothing compiled) beside the port's traced rank's dot flops times 8
(``launch/cells.py`` over a fake group of 8), with the port's split by
kernel and by aten product.  Prints one line a configuration and a JSON
line at the end.
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import Shape as JaxShape  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.launch.jaxpr_cost import cost_of as jax_cost_of  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro_torch.configs import SHAPES, Shape, get_config  # noqa: E402
from repro_torch.kernels.cost import DOT_KERNELS  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402

ARCHS = ["smollm-135m", "phi3.5-moe", "deepseek-v2", "internvl2-2b",
         "musicgen-large", "xlstm-125m", "jamba-v0.1-52b"]
NAME, SEQ, BATCH = "tiny_train", 32, 8


def main(archs):
    SHAPES[NAME] = Shape(NAME, SEQ, BATCH, "train")
    JAX_SHAPES[NAME] = JaxShape(NAME, SEQ, BATCH, "train")
    cells.get_config = lambda a: get_config(a, reduced=True)
    jax_cells.get_config = lambda a: jax_get_config(a, reduced=True)
    out = {}
    for arch in archs:
        jcell = jax_cells.build_cell(arch, NAME, jax_host_mesh(model=4))
        jax_dot = jax_cost_of(jcell.fn, *jcell.args).dot_flops
        t0 = time.perf_counter()
        with fake_world(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            _, tr = cells.build_cell(arch, NAME, mesh).trace()
        kern = {k: 8 * tr.kernels.flops[k] for k in tr.kernels.flops
                if k in DOT_KERNELS}
        aten = 8 * tr.cost.dot_flops - sum(kern.values())
        port = 8 * tr.cost.dot_flops
        out[arch] = {"jax": jax_dot, "port": port, "ratio": port / jax_dot,
                     "port_kernels": kern, "port_aten_products": aten,
                     "trace_s": time.perf_counter() - t0}
        print(f"{arch}: JAX {jax_dot:.4e} port {port:.4e} ratio "
              f"{port / jax_dot:.3f}; port by kernel "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(kern.items()))
              + f", aten products {aten:.3e}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:] or ARCHS)
