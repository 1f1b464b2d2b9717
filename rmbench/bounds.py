"""The yardstick of the roofline metrics: the card's peaks and the bytes
and float operations each kernel's share of the work needs, counted from
the cell's problem, never from the program's arguments or buffers.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores (at the 700 W power limit; a run prints
the card's limit beside its numbers). A bound is the larger of bytes over
the bandwidth and operations over the float32 rate; a roofline share is
the bound over the kernels' measured time. Each input byte is counted
once and each output byte once.

The operation counts per unit of work are copied from `chip_smoke.py`
(`COMPOSITE_STEP_OPS`, `COMPOSITE_SAMPLE_OPS`, `COMPOSITE_SHADE_OPS`,
`MARCH_*_OPS`, `OPS_PER_ELEMENT`), where each is derived from its
kernel's source; the units they multiply (samples that pass the mask,
shaded samples, march steps to termination, light voxels per face) come
from the benchmark's reference on the same frames and from the
configuration's sizes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32, TF_BYTES = 4, 256 * 4 * 4

# the composite (K1): a sample that passes the mask costs its visit (the
# coordinates, the jitter's lerps, the mask: 24) and its value and window
# (8); a shaded sample its TF taps, lerps, alpha correction, weights and
# sums (43) and its light's lerp (3)
COMPOSITE_SAMPLE_OPS = 24 + 8
COMPOSITE_SHADE_OPS = 46
# the composite's backward (K5): its forward's work again, and per shaded
# sample the adjoint (`OPS_PER_ELEMENT["composite_bwd"]`)
COMPOSITE_BWD_SHADE_OPS = 120
# the march (K9): every step (15), a sample neither clipped nor cut (67),
# one whose alpha is above 0 (73)
MARCH_STEP_OPS, MARCH_SAMPLE_OPS, MARCH_SHADE_OPS = 15, 67, 73
# the rebuild's kernels per light voxel and face: the occluder's TF alpha
# (K3, 26) and the propagation scan (K4, 20)
TF_ALPHA_OPS, LIGHT_SCAN_OPS = 26, 20


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for ``nbytes`` and ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def composite(counts: dict, n1: int, n2: int, plane_bytes: int) -> float:
    """K1's bound for one frame: each volume plane value a sample reads,
    each light plane value a shaded sample reads (``plane_bytes`` each,
    the configuration's plane type), the three per-pixel fields (jitter,
    step length, clip slope), the TF and the (4, n1, n2) float32 output,
    each once; operations per sample and shaded sample."""
    nbytes = ((counts["samples"] + counts["shaded"]) * plane_bytes
              + 3 * n1 * n2 * F32 + TF_BYTES + 4 * n1 * n2 * F32)
    ops = (counts["samples"] * COMPOSITE_SAMPLE_OPS
           + counts["shaded"] * COMPOSITE_SHADE_OPS)
    return bound_s(nbytes, ops)


def composite_bwd(counts: dict, n1: int, n2: int, planes: int,
                  plane_bytes: int) -> float:
    """K5's bound for one step: the samples' and shaded samples' plane
    values, the output's cotangent and the per-pixel fields read once,
    the two planes' gradients (``planes`` x n1 x n2 each) and the TF's
    written once; the forward's operations again and the adjoint's per
    shaded sample."""
    nbytes = ((counts["samples"] + counts["shaded"]) * plane_bytes
              + 4 * n1 * n2 * F32 + 2 * n1 * n2 * F32
              + 2 * planes * n1 * n2 * plane_bytes + 2 * TF_BYTES)
    ops = (counts["samples"] * COMPOSITE_SAMPLE_OPS
           + counts["shaded"] * (COMPOSITE_SHADE_OPS
                                 + COMPOSITE_BWD_SHADE_OPS))
    return bound_s(nbytes, ops)


def march(counts: dict, volume_voxels: int, light_voxels: int,
          pixels: int) -> float:
    """K9's bound for one frame: the volume and the light volume read
    once, the (H, W, 4) float32 frame written once; operations per step,
    per sample and per shaded sample of the reference's march."""
    nbytes = (volume_voxels + light_voxels) * F32 + TF_BYTES \
        + 4 * pixels * F32
    ops = (counts["steps"] * MARCH_STEP_OPS
           + counts["samples"] * MARCH_SAMPLE_OPS
           + counts["shaded"] * MARCH_SHADE_OPS)
    return bound_s(nbytes, ops)


def light_scan(light_voxels: int, faces: int) -> float:
    """The bound of one rebuild's K3 and K4: per face, the occluder's
    sampled values read and its opacities written (K3), the opacities
    read and the transmitted light written (K4), 4 bytes a light voxel
    each; the TF once a face."""
    nbytes = faces * (4 * light_voxels * F32 + TF_BYTES)
    ops = faces * light_voxels * (TF_ALPHA_OPS + LIGHT_SCAN_OPS)
    return bound_s(nbytes, ops)
