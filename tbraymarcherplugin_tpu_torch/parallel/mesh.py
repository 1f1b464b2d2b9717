"""Named device meshes over the process group.

Counterpart of `tbraymarcherplugin_tpu/parallel/mesh.py`, on PyTorch's own
named mesh (``torch.distributed.device_mesh.DeviceMesh``), one process per
device. Axis names used across the package:

- ``"rays"`` — data parallelism over ray tiles and shear-warp column slabs;
- ``"slab"`` — volume slab sharding along Z.

A function that runs over an axis takes the mesh and the axis name and
talks over ``mesh.get_group(axis)``, the counterpart of a named axis
inside ``shard_map``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device=None) -> DeviceMesh:
    """A named mesh over the default process group.

    ``make_mesh({"rays": 4, "slab": 2})`` lays 8 processes out as a 4x2
    grid (row-major in rank). With no arguments every process goes on one
    ``"rays"`` axis. ``device`` ("cpu" or "cuda") defaults to the group's:
    the CPU under gloo, the card under NCCL.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = {"rays": world}
    need = math.prod(axis_sizes.values())
    if need != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {need} devices, "
                         f"have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_multihost first")
    if device is None:
        device = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(torch.device(device).type,
                            tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def replicated(mesh: DeviceMesh) -> tuple:
    """DTensor placements of a tensor replicated on every mesh axis (the
    JAX package's ``NamedSharding(mesh, P())``)."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def sharded_along(mesh: DeviceMesh, axis_name: str, dim: int = 0) -> tuple:
    """DTensor placements of a tensor whose dim ``dim`` is split over the
    mesh axis ``axis_name`` and replicated on the others."""
    names = mesh.mesh_dim_names
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r}: {names}")
    return tuple(Shard(dim) if n == axis_name else Replicate() for n in names)
