"""Host meshes over the process group (port of ``repro.launch.mesh``).

``make_host_mesh`` builds a ``DeviceMesh`` over the initialized process
group's world with the reference's shapes and axis names: ``(n // model,
model)`` as ``("data", "model")``, or ``(pod, n // (pod * model), model)``
as ``("pod", "data", "model")``.  The JAX version counts ``jax.devices()``;
here the world is the process group's, one rank a device (NCCL on the
card, gloo on the CPU).  Ranks fill the mesh in row-major order, so rank r
sits at the coordinate ``np.unravel_index(r, shape)``.

``make_production_mesh`` is the dry-run's: the reference's production
shapes and axis names, (16, 16) as ``("data", "model")`` and (2, 16, 16)
as ``("pod", "data", "model")``, over a process group of the ``"fake"``
backend (``fake_world``: one process stands for every rank, rank 0, and
no collective moves data), the mesh's device type ``"cpu"`` for the fake
tensors.  A function, not a module-level constant, and the group is opened
by the dry-run's entry points, never at import, and destroyed when they
end (the reference sets ``XLA_FLAGS`` for 512 host devices at its
import).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


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


@contextmanager
def fake_world(world: int):
    """A process group of the ``"fake"`` backend over ``world`` ranks, this
    process rank 0, for the block; destroyed after it."""
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run opens its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over the fake group of its size (open it with
    ``fake_world(production_size(multi_pod))``)."""
    shape, axes = PRODUCTION[multi_pod]
    if not dist.is_initialized() or dist.get_world_size() != math.prod(
            shape):
        raise RuntimeError(f"the production mesh {shape} needs a fake "
                           f"group of {math.prod(shape)} ranks (fake_world)")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def production_size(multi_pod: bool = False) -> int:
    return math.prod(PRODUCTION[multi_pod][0])
