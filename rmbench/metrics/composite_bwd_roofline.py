"""composite_bwd_roofline: the composite backward's (K5's) share of its
roofline, %: the bound of one fit step's composite backward
(`bounds.composite_bwd`, from the reference's counts of samples and
shaded samples of the fit's frame and the configuration's fit plane
type) times the traced steps, over the device time of the kernels named
below in the traced window. A renamed kernel makes this read nothing
until a benchmark change names it here."""

from rmbench import bounds

KERNELS = ("composite_bwd_kernel",)


def read(run):
    c = run.counts.get("fit")
    if run.trace is None or c is None or not run.iterations:
        return None
    t = run.trace.kernel_s(KERNELS)
    if t <= 0.0:
        return None
    bound = run.iterations * bounds.composite_bwd(
        c, c["n1"], c["n2"], c["planes"], run.fit_plane_bytes)
    return bound / t * 100.0
