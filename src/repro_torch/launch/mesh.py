"""Production mesh definitions as torch ``DeviceMesh``es (port of
``repro.launch.mesh``).

Single pod: 16x16 = 256 devices -> ("data", "model").
Multi-pod:  2x16x16 = 512 devices -> ("pod", "data", "model").

AW/EW mapping: the ``data`` axis carries data-parallel attention workers
(disjoint request slots), the ``model`` axis the expert-parallel /
tensor-parallel group (EWs for MoE archs); ``pod`` extends data
parallelism across pods.

A ``DeviceMesh`` needs the process's default group, and nothing here makes
one on import. Three ways to have one:

* a real multi-card launch: the group ``torchrun`` sets up (NCCL);
* the dry run: ``fake_group(world_size)``, torch's fake backend, which
  builds a mesh of 256 or 512 ``cuda`` devices in one process with no card
  and turns every collective into a no-op;
* one card, and the CPU tests: ``single_rank_group(device_type)``, a
  1-rank group on a ``HashStore`` (NCCL on ``cuda``, gloo on the CPU).

A process has one default group: each context manager destroys its group
when it exits, and refuses to start while another one is up.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a process group: launch "
                           "under torchrun, or enter fake_group() or "
                           "single_rank_group() first")
    size = 1
    for s in shape:
        size *= s
    if dist.get_world_size() != size:
        raise RuntimeError(f"mesh {tuple(shape)} needs {size} ranks; the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, axes = PRODUCTION[multi_pod]
    return _mesh(shape, axes, "cuda")


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
    """Tiny mesh for one card or the CPU tests (1 rank)."""
    return _mesh(shape, axes, device_type)


def axis_sizes(mesh) -> dict:
    """name -> size of every mesh axis, in mesh order. ``mesh`` is a
    ``DeviceMesh`` or such a dict (the rule tests need no group)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """Axes that carry batch (data parallel) sharding."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def mp_axis(mesh) -> str:
    return "model"


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    s = 1
    for a in dp_axes(mesh):
        s *= sizes[a]
    return s


@contextlib.contextmanager
def _group(backend: str, store, world_size: int):
    if dist.is_initialized():
        raise RuntimeError("a default process group is already up; a "
                           "process has one")
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_group(world_size: int):
    """Rank 0 of ``world_size`` on torch's fake backend (the dry run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return _group("fake", FakeStore(), world_size)


def single_rank_group(device_type: str = "cuda"):
    """A 1-rank group on a ``HashStore``: NCCL for ``cuda``, gloo for the
    CPU."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    return _group(backend, dist.HashStore(), 1)
