"""Device meshes on a ``torch.distributed`` process group (a port of the
JAX package's ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module touches
no process group. The production meshes are the reference's: a single pod
of 16 x 16 ranks over ("data", "model"), two pods of 2 x 16 x 16 over
("pod", "data", "model"). ``pod`` is pure data parallelism across pods,
``data`` carries batch + FSDP, ``model`` carries TP / SP / EP.

``init_distributed`` joins the process group first: a torchrun-style
rendezvous from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) when one is set, else a group of one rank. It takes NCCL
for ``cuda`` and gloo for ``cpu``: a card run never gets a CPU group.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(device="cuda"):
    """Join (or reuse) the default process group for ``device``'s type and
    return (rank, world size). A CUDA rank takes the card of its
    ``LOCAL_RANK`` (its rank on the host)."""
    dev = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"up, {device} needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, rank=rank, world_size=world)
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_rank(), dist.get_world_size()


def _device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``, over the process group,
    which must hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise RuntimeError(f"the {'multi' if multi_pod else 'single'}-pod "
                           f"mesh {shape} needs {n} ranks, the process group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_sim_mesh(n_devices: int, shape=None, axes=None, device_type=None):
    """A small mesh over the process group's first ``n_devices`` ranks (all
    of them: a DeviceMesh spans its group), e.g. (1, m) or (d, m) over
    ("data", "model"). ``device_type`` defaults to the group's backend's
    (``cuda`` for NCCL, ``cpu`` for gloo); a gloo group can carry CUDA
    tensors too, with ``device_type="cuda"``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(shape or (n_devices,))
    axes = tuple(axes or (f"d{i}" for i in range(len(shape))))
    if int(np.prod(shape)) != n_devices or n_devices != dist.get_world_size():
        raise ValueError(f"mesh {shape} over {n_devices} of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)
