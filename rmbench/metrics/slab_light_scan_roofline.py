"""slab_light_scan_roofline: the sharded rebuild's kernels' (K3 and K4)
share of their roofline on rank 0, %: the bound of rank 0's share of the
rebuilds the traced iterations ask for over the device time of the
kernels named below in rank 0's traced window. Rank 0's share is its
light chunk, the light grid's voxels over the ranks, on each face of the
configuration's lights, at `bounds.light_scan`'s bytes a voxel: the
problem's share, not the program's way of splitting it, so what a rank
computes again (a light halo beside its chunk) counts as time and not as
bound (`halo_exchanges` counts the halo's exchanges). The world is the
run's process group. It reads nothing where a traced iteration moved a
light, none rebuilt, or on one card (no group)."""

import torch.distributed as dist

from rmbench import bounds

KERNELS = ("tf_alpha_kernel", "light_scan_kernel")


def read(run):
    if run.trace is None or not run.rebuilds or run.light_updates:
        return None
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    t = run.trace.kernel_s(KERNELS)
    if t <= 0.0:
        return None
    chunk = run.volume_voxels // dist.get_world_size()
    return run.rebuilds * bounds.light_scan(chunk, run.faces) / t * 100.0
