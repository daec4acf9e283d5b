"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group. Each builds a ``DeviceMesh`` with named dims over the
current process group's world, which the caller has initialised: the
dry run's fake group of 256 or 512 ranks, or torchrun's group for a
distributed training run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type() -> str:
    """"cuda" under NCCL, "cpu" under any other backend (gloo, the dry
    run's fake one)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one first "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def production_axes(multi_pod: bool = False) -> dict:
    """The production mesh's axes and sizes, in order: (16, 16) ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model")."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh (``production_axes``) over a world of exactly
    that many ranks, one dim an axis."""
    from repro_torch.dist.sharding import make_abstract_mesh
    axes = production_axes(multi_pod)
    return make_folded_mesh(make_abstract_mesh(tuple(axes.values()),
                                               tuple(axes)),
                            tuple((a,) for a in axes),
                            device_type=device_type)


def make_folded_mesh(mesh, groups, *, device_type=None):
    """The ``DeviceMesh`` of a logical ``mesh`` (``dist.sharding``'s
    ``AbstractMesh``) with its axes grouped as ``groups`` gives them
    (``dist.sharding.fold_axes``): one dim a group, its size the product
    of the group's axes, its name their names joined by
    ``dist.sharding.FOLD`` ("pod+data"). Axes in no group are left out. The
    world must be the product of the dims."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import FOLD, axis_size
    shape = []
    for g in groups:
        n = 1
        for a in g:
            n *= axis_size(mesh, a)
        shape.append(n)
    n = 1
    for s in shape:
        n *= s
    if _world() != n:
        raise ValueError(f"the mesh {tuple(shape)} needs a world of {n} "
                         f"ranks; the process group has {_world()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(FOLD.join(g)
                                                 for g in groups))


def make_host_mesh(device=None):
    """(n, 1) ("data", "model") over the group's n ranks: one CUDA device
    a rank, or the CPU when ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = torch.device(device).type if device is not None \
        else _device_type()
    return init_device_mesh(kind, (_world(), 1),
                            mesh_dim_names=("data", "model"))
