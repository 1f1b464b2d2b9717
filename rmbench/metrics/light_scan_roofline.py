"""light_scan_roofline (and light_scan_roofline.<part>, in cells that
report another end-to-end metric): the illumination rebuild's kernels'
(K3 and K4) share of their roofline, %: the bound of the rebuilds the traced
iterations ask for (`bounds.light_scan`, from the light volume's voxels
and each light's faces) over the device time of the kernels named below
in the traced window. It reads nothing where a traced iteration moved a
light (`change_dir_light`, other work than a rebuild) or none rebuilt. A
renamed kernel makes this read nothing until a benchmark change names it
here."""

from rmbench import bounds

KERNELS = ("tf_alpha_kernel", "light_scan_kernel")


def read(run):
    if run.trace is None or not run.rebuilds or run.light_updates:
        return None
    t = run.trace.kernel_s(KERNELS)
    if t <= 0.0:
        return None
    bound = run.rebuilds * bounds.light_scan(run.volume_voxels, run.faces)
    return bound / t * 100.0
