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


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over a world of exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if _world() != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} "
                         f"ranks; the process group has {_world()}")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None):
    """(n, 1) ("data", "model") over the group's n ranks: one CUDA device
    a rank, or the CPU when ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = torch.device(device).type if device is not None \
        else _device_type()
    return init_device_mesh(kind, (_world(), 1),
                            mesh_dim_names=("data", "model"))
