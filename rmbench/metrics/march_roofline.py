"""march_roofline (and march_roofline.<part>, in cells that report
another end-to-end metric): the lit ray march's (K9's) share of its
roofline, %:
the bound of the sampled traced march frames (`bounds.march`, from the
reference's counts of steps, samples and shaded samples on the same
frames and the configuration's sizes) over the device time of the
kernels named below in those frames. A renamed kernel makes this read
nothing until a benchmark change names it here."""

from rmbench import bounds

KERNELS = ("march_kernel",)


def read(run):
    if run.trace is None:
        return None
    its = {i: c for i, c in run.counts.items() if c.get("kind") == "march"}
    t = run.trace.kernel_s(KERNELS, set(its))
    if not its or t <= 0.0:
        return None
    bound = sum(bounds.march(c, run.volume_voxels, run.volume_voxels,
                             run.pixels) for c in its.values())
    return bound / t * 100.0
