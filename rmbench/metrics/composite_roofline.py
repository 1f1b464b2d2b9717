"""composite_roofline (and composite_roofline.<part>, in cells that
report another end-to-end metric): the lit composite's (K1's) share of
its roofline, %: the bound of the sampled traced frames' composites (`bounds.composite`,
from the reference's counts of samples and shaded samples on the same
frames and the configuration's plane type) over the device time of the
kernels named below in those frames. A renamed kernel makes this read
nothing until a benchmark change names it here."""

from rmbench import bounds

KERNELS = ("composite_kernel",)


def read(run):
    if run.trace is None:
        return None
    its = {i: c for i, c in run.counts.items()
           if c.get("kind") == "composite"}
    t = run.trace.kernel_s(KERNELS, set(its))
    if not its or t <= 0.0:
        return None
    bound = sum(bounds.composite(c, c["n1"], c["n2"], run.plane_bytes)
                for c in its.values())
    return bound / t * 100.0
