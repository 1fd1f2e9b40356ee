"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
world group, with the reference's axis names (``"pod"``, ``"data"``,
``"model"``).  :func:`make_mesh` takes the world the caller started
(``torch.distributed.init_process_group``, any backend); where none was
started and the mesh has one device, it starts a world of one process on
gloo from an in-memory ``HashStore``, so that a single process (the CLI on
one card) needs no ``MASTER_ADDR``.  That world lives as long as the
process, as a JAX process's devices do.

Functions, never module-level meshes, so that importing this module starts
no group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

__all__ = ["make_mesh", "make_production_mesh", "batch_axes", "model_axis", "axis_sizes"]


def make_mesh(shape, axes, device=DEFAULT_DEVICE) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks
    in order, for ``device``'s type.  The world's size must be
    ``prod(shape)``; ``"cuda"`` without a GPU raises ``RuntimeError``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = torch_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices {shape} needs a world of {n} ranks; no "
                "process group is initialized (a world of 1 is started only for "
                "a mesh of one device)")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a mesh of {n} devices {shape} over a world of {world} ranks")
    if dev.type == "cuda":
        torch.cuda.current_device()   # CUDA up first: the mesh then picks no device itself
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=DEFAULT_DEVICE) -> DeviceMesh:
    """16x16 = 256 devices a pod; ``multi_pod`` adds the 2-pod leading axis
    (512).  Needs a world of that many ranks (a dry run: the ``fake``
    backend)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def axis_sizes(mesh) -> dict[str, int]:
    """The reference's ``mesh.shape``: axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the batch (data parallel, incl. pods)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis(mesh) -> str:
    return "model"
