"""Device meshes (the port's copy of the reference's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group that stands: start the ranks with ``torchrun`` (or
``init_process_group``) first.  Shapes:

  single-pod:  (16, 16)      axes (data, model)        — 256 GPUs
  multi-pod:   (2, 16, 16)   axes (pod, data, model)   — 512 GPUs

``make_test_mesh`` builds any shape the world holds, as the tests' Gloo
worlds on the CPU and ``launch/train.py --mesh DxM`` do.  The device type
follows the process group's backend: NCCL meshes are ``cuda``, Gloo ones
``cpu``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_test_mesh(shape: Sequence[int] = (2, 4), axes: Sequence[str] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A mesh of ``shape`` over the whole world; raises unless the world has
    exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with torchrun (or "
                           "init_process_group) before building a mesh")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device_type)
