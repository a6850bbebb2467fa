"""Device meshes (the port's copy of the reference's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group that stands: start the ranks with ``torchrun`` (or
``init_process_group``) first.  Shapes:

  single-pod:  (16, 16)      axes (data, model)        — 256 GPUs
  multi-pod:   (2, 16, 16)   axes (pod, data, model)   — 512 GPUs

``make_test_mesh`` builds any shape the world holds, as the tests' Gloo
worlds on the CPU do.  The device type follows the process group's
backend: NCCL meshes are ``cuda``, Gloo ones ``cpu``.  ``build_mesh``
reads both launchers' ``--mesh`` (``launch/train.py``, ``launch/serve.py``)
and starts the process group it needs (``init_distributed``): NCCL with a
rank a GPU (``rank_device``: ``cuda:LOCAL_RANK``), Gloo on the CPU.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.models.model import resolve_device


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


def _world() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device: Optional[str]) -> torch.device:
    """``resolve_device``, on torchrun's ``cuda:LOCAL_RANK`` for a GPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def init_distributed(device: torch.device) -> bool:
    """Start the process group unless one stands: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    else a world of one over a file store.  NCCL for a CUDA device, Gloo for
    the CPU.  Returns whether it started one."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


def build_mesh(spec: str, device: torch.device):
    """A launcher's ``--mesh``: ``none`` -> no mesh (one process); ``auto``
    -> (world, 1) when the world has several ranks, else no mesh; ``DxM`` ->
    a (data, model) mesh of D·M = ``WORLD_SIZE`` ranks.  A mesh the world
    cannot hold raises, and so does ``none`` on a world of several ranks (it
    would run one replica a rank).  Starts the process group a mesh needs
    (``init_distributed``)."""
    world = _world()
    if spec == "none":
        if world > 1:
            raise ValueError(f"--mesh none on a world of {world} ranks would run one replica "
                             "a rank; give --mesh auto or DxM")
        return None
    if spec == "auto":
        if world == 1:
            return None
        shape = (world, 1)
    else:
        try:
            shape = tuple(int(x) for x in spec.lower().split("x"))
        except ValueError:
            raise ValueError(f"--mesh wants none, auto or DxM (e.g. 2x4), got {spec!r}")
        if len(shape) != 2 or shape[0] * shape[1] != world:
            raise ValueError(f"--mesh {spec} needs a world of "
                             f"{shape[0] * shape[-1]} ranks (torchrun's WORLD_SIZE); it has "
                             f"{world}")
    init_distributed(device)
    return make_test_mesh(shape, ("data", "model"))
