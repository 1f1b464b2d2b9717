"""band_composite_roofline: the lit composite's (K1's) share of its
roofline on rank 0's column band of a sharded frame, %: the bound of the
sampled traced frames' composites over rank 0's band
(`bounds.composite`, from the reference's counts of samples and shaded
samples in the first n2 / n columns of the intermediate image, n the
run's ranks, which the reference `reference/slab_blocks.py` gives under
``bands``) over the device time of the kernels named below in those
frames on rank 0. It reads nothing on one card (no group) or where the
reference gave no band counts. A renamed kernel makes this read nothing
until a benchmark change names it here."""

import torch.distributed as dist

from rmbench import bounds

KERNELS = ("composite_kernel",)


def read(run):
    if run.trace is None or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    its = {i: c for i, c in run.counts.items()
           if c.get("kind") == "composite" and world in c.get("bands", {})}
    t = run.trace.kernel_s(KERNELS, set(its))
    if world < 2 or not its or t <= 0.0:
        return None
    bound = sum(bounds.composite(c["bands"][world], c["n1"],
                                 c["n2"] // world, run.plane_bytes)
                for c in its.values())
    return bound / t * 100.0
