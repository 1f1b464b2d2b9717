"""Parallelism on ``torch.distributed``: named device meshes, ray-tile data
parallelism, the column-sharded shear-warp with its gradients, volume slab
sharding and the overlapped gradient all-reduce.

Counterpart of `tbraymarcherplugin_tpu/parallel/` (``shard_map`` over a
named mesh): one process per device, a mesh axis is a process group
(``mesh.get_group(axis)``), NCCL on the card and gloo on the CPU
(`distributed.initialize_multihost`). Every rank is handed the same global
inputs, works on its share and gets the global result, except in the
slab-local rebuild (`compute_illumination_sharded_v2`), which takes the
rank's Z slab and returns its Z chunk.
"""

from .mesh import make_mesh, replicated, sharded_along
from .overlap import psum_cotangent
from .ray_sharding import (
    make_sharded_train_step,
    pad_rays_for_mesh,
    render_lit_sharded,
)
from .shearwarp_sharding import (
    shearwarp_lit_sharded,
    shearwarp_lit_sharded_diff,
)
from .slab_sharding import (
    compute_illumination_sharded_v2,
    march_lit_slab_ring,
    march_lit_slab_sharded,
)

__all__ = [
    "compute_illumination_sharded_v2",
    "make_mesh",
    "make_sharded_train_step",
    "march_lit_slab_ring",
    "march_lit_slab_sharded",
    "pad_rays_for_mesh",
    "psum_cotangent",
    "render_lit_sharded",
    "shearwarp_lit_sharded",
    "shearwarp_lit_sharded_diff",
    "replicated",
    "sharded_along",
]
