"""Host meshes over the process group (port of ``repro.launch.mesh``).

``make_host_mesh`` builds a ``DeviceMesh`` over the initialized process
group's world with the reference's shapes and axis names: ``(n // model,
model)`` as ``("data", "model")``, or ``(pod, n // (pod * model), model)``
as ``("pod", "data", "model")``.  The JAX version counts ``jax.devices()``;
here the world is the process group's, one rank a device (NCCL on the
card, gloo on the CPU).  Ranks fill the mesh in row-major order, so rank r
sits at the coordinate ``np.unravel_index(r, shape)``.

The reference's ``make_production_mesh`` is a shape for the dry-run and
waits for that slice.
"""

from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def host_mesh_shape(n: int, model: int = 1, *, pod: int = 0
                    ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the host mesh over ``n`` devices."""
    if pod:
        if n % (pod * model):
            raise ValueError(f"{n} devices do not split into {pod} pods of "
                             f"model axis {model}")
        return (pod, n // (pod * model), model), ("pod", "data", "model")
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {n}")
    return (n // model, model), ("data", "model")


def make_host_mesh(model: int = 1, *, pod: int = 0,
                   device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    shape, axes = host_mesh_shape(dist.get_world_size(), model, pod=pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
