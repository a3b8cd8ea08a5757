"""Device meshes (port of ``repro/launch/mesh.py``).

The reference's production target is TPU v5e: 256 chips a pod as a
(data=16, model=16) mesh, and two pods with a leading "pod" axis.  The
port builds a ``torch.distributed.device_mesh.DeviceMesh`` of the same
shape and axis names over the process group that is up: a real world
under ``torchrun`` (NCCL on the card, gloo on the CPU), or the in-process
fake world of 256 or 512 ranks that the dry run starts (``fake_world``).
Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket
from typing import Iterator, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POD_MESH = ((16, 16), ("data", "model"))
MULTI_POD_MESH = ((2, 16, 16), ("pod", "data", "model"))


def _device_type() -> str:
    """The mesh's device type: "cuda" when the group's backend is NCCL,
    else "cpu" (gloo, and the fake world, whose tensors live on the meta
    device and need no device of their own)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first prod(shape) ranks
    of the world; raises, as the reference does, when the world is
    smaller (a larger world keeps its first ranks, as the reference takes
    the first of 512 forced host devices for one pod)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: run under torchrun, or inside "
                           "fake_world() for a dry run")
    n, world = math.prod(shape), dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world}: run under "
            f"torchrun --nproc-per-node {n}, or inside fake_world({n}) "
            f"(the dry run starts one)")
    if world == n:
        return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)
    if dist.get_rank() >= n:
        raise RuntimeError(f"rank {dist.get_rank()} is outside the mesh of "
                           f"the first {n} ranks")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape, axes = MULTI_POD_MESH if multi_pod else POD_MESH
    return make_mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A small ("data", "model") mesh for tests and examples."""
    return make_mesh((data, model), ("data", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension (pod folds into data-parallel).
    ``mesh`` is a ``DeviceMesh`` or a shape-only stand-in with
    ``axis_names``."""
    names = axis_names(mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    whose ``shape`` is that dict already (the reference tests'
    ``FakeMesh``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """An in-process process group of ``world_size`` ranks (this process
    is rank 0) whose collectives do nothing: the dry run's stand-in for a
    pod.  Tensors of a step run on it live on the meta device, so nothing
    is allocated and every collective is only counted.  The group is
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(backend: str) -> None:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment), or start a world
    of one rank on a free localhost port when run without it."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
