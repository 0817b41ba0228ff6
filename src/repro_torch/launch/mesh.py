"""Production meshes: the port's copy of the JAX package's
``repro.launch.mesh``, over ``torch.distributed``.

Functions, not module-level constants, so importing this module touches
no device and starts no process group.  A mesh is a ``DeviceMesh`` with
the reference's axis names.  Its ranks come from the process group: under
``torchrun`` (``torchrun --nproc-per-node N -m ...``) the default group is
started from the environment; a host mesh of one rank outside ``torchrun``
starts its own world-1 group on an in-process store.  On the CPU the group
is gloo's, on the card NCCL's.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _world(n: int, device_type: str) -> int:
    """The world size, starting the default group if none is: from
    ``torchrun``'s environment when it set one, else (a mesh of one rank)
    a world-1 group on a ``HashStore``."""
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(device_type))
        elif n == 1:
            kw = {}
            if device_type == "cuda":
                kw["device_id"] = torch.device("cuda",
                                               torch.cuda.current_device())
            dist.init_process_group(_backend(device_type),
                                    store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
        else:
            return 1
    return dist.get_world_size()


def _mesh(shape, names, device_type, hint=""):
    n = math.prod(shape)
    world = _world(n, device_type)
    if world < n:
        raise RuntimeError(f"need {n} devices, have {world}{hint}")
    if world > n:
        raise RuntimeError(f"the mesh {dict(zip(names, shape))} takes {n} "
                           f"ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 ranks (data, model); 2 x 16 x 16 (pod, data, model) for the
    multi-pod run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type,
                 hint=f"; run under torchrun --nproc-per-node "
                      f"{math.prod(shape)}")


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small (data, model) mesh over the ranks of this host (tests,
    examples)."""
    return _mesh((data, model), ("data", "model"), device_type)
