"""Illumination volume: per-light slice-by-slice propagation.

Counterpart of `tbraymarcherplugin_tpu/ops/lighting.py` (the reference's
`AddDirLightShader.usf`, `ChangeDirLightShader.usf` and
`LightingShaders.cpp`). The axis math is host numpy, copied from the JAX
package. Per face, the occluder opacity of every light voxel is computed
in one pass (constant-offset trilinear resample, then kernel K3,
`tf_alpha.py`) and the slice scan runs as kernel K4 (`light_scan.py`).

Both are the differentiable units (backward kernels K8 and K7), so the
whole rebuild takes gradients to the volume, the TF table, the window and
``light_alpha`` (a 0-d tensor there) as the JAX package's differentiable
callers do (`tf_impl="pallas_vjp"`, `scan_impl="pallas"`). The resample's
shifted slices stay slices: their adjoint on the GPU is a copy, where the
JAX package switches to selection matmuls for the TPU's sake.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .light_scan import propagate_face_scan_vjp
from .sampling import VOLUME_DENSITY, clip_soft_alpha_weight, trilinear_sample
from .tf_alpha import windowed_tf_alpha_vjp

# Per-voxel light deltas at or below this are not written
# (`AddDirLightShader.usf:123`, `ChangeDirLightShader.usf:152`).
WRITE_SKIP_THRESHOLD = 1e-3

# Cube faces in reference order (`LightingShaderUtils.h:35-42`).
FACE_NORMALS = np.array([
    [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
    [0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
])


class MajorAxes(NamedTuple):
    """Top-2 propagation faces with their renormalized weights."""

    faces: tuple[int, int]
    weights: tuple[float, float]


def get_major_axes(light_pos) -> list[tuple[int, float]]:
    """All 6 faces weighted by squared positive cosine, sorted descending
    (`FMajorAxes::GetMajorAxes`). ``light_pos`` points TO the light."""
    light_pos = np.asarray(light_pos, np.float64)
    weights = FACE_NORMALS @ light_pos
    weights = np.where(weights > 0, weights * weights, 0.0)
    order = np.argsort(-weights, kind="stable")
    return [(int(f), float(weights[f])) for f in order]


def local_light_major_axes(local_light_dir) -> MajorAxes:
    """Top-2 faces + weights; a dominant weight above 0.99 snaps to 1
    (`GetLocalLightParamsAndAxes`, `LightingShaderUtils.cpp:160-188`)."""
    d = np.asarray(local_light_dir, np.float64)
    d = d / np.linalg.norm(d)
    ranked = get_major_axes(-d)
    w0 = ranked[0][1]
    if w0 > 0.99:
        w0 = 1.0
    return MajorAxes(faces=(ranked[0][0], ranked[1][0]),
                     weights=(float(w0), float(1.0 - w0)))


def face_axis(face: int) -> int:
    """Volume axis (0/1/2) a face propagates along."""
    return face // 2


def face_direction(face: int) -> int:
    """+1 = slices walk upward along the axis, -1 = downward."""
    return 1 if face % 2 else -1


def transposed_axes(face: int) -> tuple[int, int, int]:
    """(buffer_x, buffer_y, propagation) axis permutation of a face."""
    return {0: (1, 2, 0), 1: (0, 2, 1), 2: (0, 1, 2)}[face_axis(face)]


def face_uv_offset(face: int, light_pos, transposed_dims) -> tuple:
    """Per-slice read-buffer UV offset toward the light (`GetUVOffset`)."""
    axis = face_axis(face)
    sign = 1.0 if face % 2 == 0 else -1.0
    lp = np.asarray(light_pos, np.float64)
    lp = lp / (sign * lp[axis])
    bx_axis, by_axis, _ = transposed_axes(face)
    return (lp[bx_axis] / transposed_dims[2], lp[by_axis] / transposed_dims[2])


def face_step_and_uvw_offset(face: int, light_pos, transposed_dims,
                             min_dim: int):
    """(step_size, uvw_offset) of the occluder sample
    (`GetStepSizeAndUVWOffset` + `LightingShaders.cpp:119-124`)."""
    axis = face_axis(face)
    lp = np.asarray(light_pos, np.float64)
    raw = lp / (abs(lp[axis]) * transposed_dims[2])
    step_size = float(np.linalg.norm(raw))
    unit = raw / np.linalg.norm(raw)
    return step_size, tuple(float(c) for c in unit / min_dim)


class FacePropagationPlan(NamedTuple):
    """Host-side geometry of one face's propagation."""

    face: int
    uv_offset: tuple[float, float]
    uvw_offset: tuple[float, float, float]
    step_size: float
    light_alpha: float  # intensity * face weight (the weight in a LightPlan)


def plan_face_propagation(face: int, light_pos, light_dims,
                          intensity_times_weight) -> FacePropagationPlan:
    ax = transposed_axes(face)
    tdims = (light_dims[ax[0]], light_dims[ax[1]], light_dims[ax[2]])
    lp = np.asarray(light_pos, np.float64)
    uv_off = face_uv_offset(face, lp, tdims)
    step_size, uvw_off = face_step_and_uvw_offset(face, lp, tdims,
                                                  min(light_dims))
    return FacePropagationPlan(face, uv_off, uvw_off, step_size,
                               intensity_times_weight)


def _const_shift_trilinear(volume: torch.Tensor, light_dims, uvw_offset):
    """Trilinear resample of ``volume`` at light-grid centers + a constant
    UVW offset, for integer volume/light resolution ratios r: the position
    of light voxel g is g * r + c with a constant c per axis, so every
    sample has the same fractional weights. Full resolution: 8 shifted
    slices of an edge-padded volume; downsampling: three separable banded
    selection matmuls. Edge padding gives clamp-to-edge corners."""
    vd = tuple(int(d) for d in volume.shape)
    ld = tuple(int(d) for d in light_dims)
    r = tuple(v // l for v, l in zip(vd, ld))
    off = np.asarray(uvw_offset, np.float32)
    pads = tuple(r[a] + 2 + -(-r[a] * ld[a] // min(ld)) for a in range(3))
    vp = F.pad(volume[None, None],
               (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0]),
               mode="replicate")[0, 0]
    i0, frac = [], []
    for a in range(3):
        c = np.float32(0.5 * r[a] - 0.5) + off[a] * np.float32(vd[a])
        f = np.floor(c)
        frac.append(np.float32(c - f))
        i0.append(int(np.clip(int(f) + pads[a], 0, 2 * pads[a] + r[a] - 2)))
    fx, fy, fz = frac
    one = np.float32(1.0)
    gx, gy, gz = (float(one - f) for f in frac)
    fx, fy, fz = float(fx), float(fy), float(fz)
    if all(v == 1 for v in r):
        def corner(dx, dy, dz):
            return vp[i0[0] + dx:i0[0] + dx + ld[0],
                      i0[1] + dy:i0[1] + dy + ld[1],
                      i0[2] + dz:i0[2] + dz + ld[2]]

        c00 = corner(0, 0, 0) * gz + corner(0, 0, 1) * fz
        c01 = corner(0, 1, 0) * gz + corner(0, 1, 1) * fz
        c10 = corner(1, 0, 0) * gz + corner(1, 0, 1) * fz
        c11 = corner(1, 1, 0) * gz + corner(1, 1, 1) * fz
        c0 = c00 * gy + c01 * fy
        c1 = c10 * gy + c11 * fy
        return c0 * gx + c1 * fx

    def sel(axis, f, g1):
        g = torch.arange(ld[axis], device=vp.device) * r[axis] + i0[axis]
        j = torch.arange(vp.shape[axis], device=vp.device)
        return ((j[None, :] == g[:, None]).float() * g1
                + (j[None, :] == (g + 1)[:, None]).float() * f)

    t = torch.einsum("gx,xyz->gyz", sel(0, fx, gx), vp)
    t = torch.einsum("hy,gyz->ghz", sel(1, fy, gy), t)
    return torch.einsum("iz,ghz->ghi", sel(2, fz, gz), t)


def occluder_opacity_volume(volume, tf_table, windowing_vec4, light_dims,
                            uvw_offset, step_size, clip_center,
                            clip_direction):
    """Per-voxel occluder opacity of one face (`AddDirLightShader.usf:84-114`):
    the volume sampled at each light voxel center offset toward the light,
    windowed TF alpha (kernels K3/K8), times the soft clip weight; zero
    where the offset sample leaves [0, 1]^3. Returns a ``light_dims``
    tensor."""
    dev = volume.device
    res = torch.tensor(light_dims, dtype=torch.float32, device=dev)
    grids = torch.meshgrid(
        *[torch.arange(d, dtype=torch.float32, device=dev) for d in light_dims],
        indexing="ij",
    )
    off = torch.as_tensor(np.asarray(uvw_offset, np.float32), device=dev)
    uvw = (torch.stack(grids, dim=-1) + 0.5) / res + off
    alpha_weight = clip_soft_alpha_weight(uvw, clip_center, clip_direction,
                                          res)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    vd = tuple(volume.shape)
    if all(v % l == 0 for v, l in zip(vd, light_dims)):
        value = _const_shift_trilinear(volume, light_dims, uvw_offset)
    else:
        value = trilinear_sample(volume, uvw)
    step = float(np.float32(step_size) * np.float32(VOLUME_DENSITY))
    opacity = windowed_tf_alpha_vjp(value, tf_table, windowing_vec4, step)
    keep = inside & (alpha_weight > 0.0)
    return torch.where(keep, opacity * alpha_weight,
                       torch.zeros_like(opacity))


def _propagate_one_face(volume, tf_table, windowing_vec4, clip_center,
                        clip_direction, uv_off, uvw_off, step_size,
                        light_alpha, face: int, light_dims,
                        apply_write_threshold: bool = True):
    """Transmitted light of one face's share of a light, shape
    ``light_dims``: occluder field, transpose so propagation is the scan
    axis, flip so the scan walks slice 0 -> N-1, scan (kernels K4/K7),
    threshold, and undo the flip and transpose. ``light_alpha`` is a
    number or a 0-d tensor."""
    ax = transposed_axes(face)
    tdims = (light_dims[ax[0]], light_dims[ax[1]], light_dims[ax[2]])
    opacity = occluder_opacity_volume(
        volume, tf_table, windowing_vec4, light_dims, uvw_off, step_size,
        clip_center, clip_direction,
    )
    opacity_t = opacity.permute(ax)
    if face_direction(face) == -1:
        opacity_t = opacity_t.flip(2)
    uv = np.asarray(uv_off, np.float32)
    off_px = uv[0] * np.float32(tdims[0])
    off_py = uv[1] * np.float32(tdims[1])
    slices = propagate_face_scan_vjp(opacity_t.movedim(2, 0).contiguous(),
                                     off_px, off_py, light_alpha)
    result_t = slices.movedim(0, 2)
    if apply_write_threshold:
        result_t = torch.where(result_t.abs() > WRITE_SKIP_THRESHOLD,
                               result_t, torch.zeros_like(result_t))
    if face_direction(face) == -1:
        result_t = result_t.flip(2)
    inv = [0, 0, 0]
    for i, a in enumerate(ax):
        inv[a] = i
    return result_t.permute(inv).contiguous()


def compute_light_contribution(volume, tf_table, windowing_vec4, clip_center,
                               clip_direction, local_light_dir, intensity,
                               light_dims, apply_write_threshold: bool = True):
    """Transmitted-light field of one directional light: its top-2 faces
    each propagate ``intensity * weight`` and the two fields add
    (`LightingShaders.cpp:91-159`)."""
    local_light_dir = np.asarray(local_light_dir, np.float64)
    local_light_dir = local_light_dir / np.linalg.norm(local_light_dir)
    axes = local_light_major_axes(local_light_dir)
    light_pos = -local_light_dir
    light_dims = tuple(int(d) for d in light_dims)
    total = torch.zeros(light_dims, dtype=torch.float32, device=volume.device)
    for face, weight in zip(axes.faces, axes.weights):
        if weight == 0.0:
            continue
        plan = plan_face_propagation(face, light_pos, light_dims, weight)
        total = total + _propagate_one_face(
            volume, tf_table, windowing_vec4, clip_center, clip_direction,
            plan.uv_offset, plan.uvw_offset, plan.step_size,
            np.float32(intensity) * np.float32(weight), face, light_dims,
            apply_write_threshold,
        )
    return total


def add_dir_light(light_volume, volume, tf_table, windowing_vec4,
                  clip_center, clip_direction, local_light_dir, intensity,
                  added: bool = True, apply_write_threshold: bool = True):
    """Add (or with ``added=False`` remove) one light's contribution
    (`AddDirLightToSingleLightVolume_RenderThread`)."""
    contrib = compute_light_contribution(
        volume, tf_table, windowing_vec4, clip_center, clip_direction,
        local_light_dir, intensity, light_volume.shape,
        apply_write_threshold,
    )
    return light_volume + (contrib if added else -contrib)


def change_dir_light(light_volume, volume, tf_table, windowing_vec4,
                     clip_center, clip_direction, old_local_dir,
                     old_intensity, new_local_dir, new_intensity,
                     apply_write_threshold: bool = True):
    """Selective update: swap one light's old parameters for new ones; the
    write threshold applies to the delta (`ChangeDirLightShader.usf:151-155`)."""
    args = (volume, tf_table, windowing_vec4, clip_center, clip_direction)
    old_c = compute_light_contribution(
        *args, old_local_dir, old_intensity, light_volume.shape, False)
    new_c = compute_light_contribution(
        *args, new_local_dir, new_intensity, light_volume.shape, False)
    delta = new_c - old_c
    if apply_write_threshold:
        delta = torch.where(delta.abs() > WRITE_SKIP_THRESHOLD, delta,
                            torch.zeros_like(delta))
    return light_volume + delta


def clear_light_volume(light_dims, value: float = 0.0, device=None):
    """A fresh light volume (`ClearVolumeTexture_RenderThread`)."""
    return torch.full(tuple(light_dims), value, dtype=torch.float32,
                      device=device)


def reset_all_lights(volume, tf_table, windowing_vec4, clip_center,
                     clip_direction, lights_local, light_dims,
                     apply_write_threshold: bool = True):
    """Full rebuild: clear, then add every (local_dir, intensity) light."""
    lv = clear_light_volume(light_dims, device=volume.device)
    for local_dir, intensity in lights_local:
        lv = add_dir_light(
            lv, volume, tf_table, windowing_vec4, clip_center,
            clip_direction, local_dir, intensity, True,
            apply_write_threshold,
        )
    return lv
