"""Meshes of the training path (port of ``repro.launch.mesh``).

The reference's host mesh is one jitted program over every local device.
PyTorch's counterpart is one process per rank, each on its own card
(``cuda:{LOCAL_RANK}`` under ``torchrun``), joined by a
``torch.distributed`` group, with a ``DeviceMesh`` naming the ranks'
axes ("data", "model").  The backend is NCCL on the card and gloo on the
CPU.  Functions, never module-level constants, so importing this module
touches no device or group.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def init_group(device=None) -> bool:
    """Join the process group of this run if there is none yet; True when
    this call set it up (the caller then destroys it).

    Under ``torchrun`` (``WORLD_SIZE`` and ``MASTER_ADDR`` in the
    environment) the group spans its ranks; otherwise it is a one-rank
    group in this process, so a plain run takes the same path on a
    1 × 1 mesh.  The backend is NCCL for a CUDA ``device`` (whose index
    becomes the current device), gloo for the CPU."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        rank = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(rank) if rank is not None else torch.cuda.current_device())
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the running ranks, in rank order.

    When the shape holds fewer ranks than the world, the world splits into
    world / size meshes of that shape (a shrunk mesh's replicas) and each
    rank gets the one it is in.  Raises when the shape does not divide the
    world."""
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if world % size:
        raise ValueError(f"a {shape} mesh needs a multiple of {size} ranks, "
                         f"the process group has {world}")
    if size == world:
        return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))
    full = init_device_mesh(_device_type(), (world // size,) + tuple(shape),
                            mesh_dim_names=("replica",) + tuple(axes))
    return full[tuple(axes)]


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """(world // model, model) over ("data", "model") on the running
    ranks; sets up a one-rank group for ``device`` when none is running."""
    init_group(device)
    world = dist.get_world_size()
    model = max(1, min(model, world))
    return make_mesh((world // model, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``; raises unless the group
    has 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} ranks "
                           f"(torchrun --nnodes ... --nproc-per-node ...); the process group "
                           f"has {world or 'not been set up'}")
    return make_mesh(shape, axes)


def mesh_device(mesh: Optional[DeviceMesh]) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
