"""Illumination volume: per-light slice-by-slice propagation.

Counterpart of `tbraymarcherplugin_tpu/ops/lighting.py` (the reference's
`AddDirLightShader.usf`, `ChangeDirLightShader.usf` and
`LightingShaders.cpp`). The axis math is host numpy, copied from the JAX
package. Per face, the occluder opacity of every light voxel is one launch
of kernel K3's occluder source (`csrc/tf_alpha.cu`): it samples the volume
at each light voxel's offset center (constant-offset trilinear), applies
the cube test, the soft clip weight and the windowed TF alpha in
registers, and writes only the opacity (:func:`occluder_opacity`). The
slice scan runs as kernel K4 (`light_scan.py`).

Both are the differentiable units (backward kernels K8 and K7), so the
whole rebuild takes gradients to the volume, the TF table, the window and
``light_alpha`` (a 0-d tensor there) as the JAX package's differentiable
callers do (`tf_impl="pallas_vjp"`, `scan_impl="pallas"`). The volume's
cotangent is the adjoint of the resample's PyTorch form
(:func:`_const_shift_trilinear`: shifted slices, whose adjoint on the GPU is
a copy, where the JAX package switches to selection matmuls for the TPU's
sake), run only when it is asked for.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import to_device
from ..utils.profiling import LIGHT_SCAN, OCCLUDER, TF_ALPHA_BWD, span
from . import _kernels, tf_alpha
from .light_scan import propagate_face_scan_vjp
from .sampling import VOLUME_DENSITY, clip_soft_alpha_weight, trilinear_sample
from .tf_alpha import windowed_tf_alpha_plain

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


class _Shift(NamedTuple):
    """The constant-offset resample of a light grid: per axis the
    volume/light ratio ``r``, the edge pad, the first corner ``i0`` of
    light voxel 0 in the padded volume and the weight ``frac`` of the
    second corner (float32)."""

    r: tuple
    pads: tuple
    i0: tuple
    frac: tuple


def _const_shift(volume_dims, light_dims, uvw_offset):
    """The :class:`_Shift` of light voxel centers + ``uvw_offset`` for
    integer volume/light ratios, else None: the position of light voxel g
    is g * r + c with a constant c per axis, so every sample has the same
    fractional weights. The pads hold every offset a face plan gives."""
    vd = tuple(int(d) for d in volume_dims)
    ld = tuple(int(d) for d in light_dims)
    if any(v % l for v, l in zip(vd, ld)):
        return None
    r = tuple(v // l for v, l in zip(vd, ld))
    off = np.asarray(uvw_offset, np.float32)
    pads = tuple(r[a] + 2 + -(-r[a] * ld[a] // min(ld)) for a in range(3))
    i0, frac = [], []
    for a in range(3):
        c = np.float32(0.5 * r[a] - 0.5) + off[a] * np.float32(vd[a])
        f = np.floor(c)
        frac.append(np.float32(c - f))
        i0.append(int(np.clip(int(f) + pads[a], 0, 2 * pads[a] + r[a] - 2)))
    return _Shift(r, pads, tuple(i0), tuple(frac))


def _weights(shift: _Shift):
    """Per axis (1 - frac, frac), float32 values held in Python floats."""
    one = np.float32(1.0)
    return ([float(one - f) for f in shift.frac],
            [float(f) for f in shift.frac])


def _trilerp(corner, shift: _Shift):
    """The constant-weight trilinear lerp of the 8 ``corner(dx, dy, dz)``
    fields, along z, then y, then x."""
    (gx, gy, gz), (fx, fy, fz) = _weights(shift)
    c00 = corner(0, 0, 0) * gz + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * gz + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * gz + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * gz + corner(1, 1, 1) * fz
    c0 = c00 * gy + c01 * fy
    c1 = c10 * gy + c11 * fy
    return c0 * gx + c1 * fx


def _const_shift_trilinear(volume: torch.Tensor, light_dims, uvw_offset):
    """Trilinear resample of ``volume`` at light-grid centers + a constant
    UVW offset, for integer volume/light resolution ratios r
    (:func:`_const_shift`). Full resolution: 8 shifted slices of an
    edge-padded volume; downsampling: three separable banded selection
    matmuls. Edge padding gives clamp-to-edge corners. Differentiable: the
    adjoint of the occluder's resample."""
    ld = tuple(int(d) for d in light_dims)
    r, pads, i0, _ = shift = _const_shift(volume.shape, ld, uvw_offset)
    vp = F.pad(volume[None, None],
               (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0]),
               mode="replicate")[0, 0]
    if all(v == 1 for v in r):
        return _trilerp(lambda dx, dy, dz: vp[i0[0] + dx:i0[0] + dx + ld[0],
                                              i0[1] + dy:i0[1] + dy + ld[1],
                                              i0[2] + dz:i0[2] + dz + ld[2]],
                        shift)

    (gx, gy, gz), (fx, fy, fz) = _weights(shift)

    def sel(axis, f, g1):
        g = torch.arange(ld[axis], device=vp.device) * r[axis] + i0[axis]
        j = torch.arange(vp.shape[axis], device=vp.device)
        return ((j[None, :] == g[:, None]).float() * g1
                + (j[None, :] == (g + 1)[:, None]).float() * f)

    t = torch.einsum("gx,xyz->gyz", sel(0, fx, gx), vp)
    t = torch.einsum("hy,gyz->ghz", sel(1, fy, gy), t)
    return torch.einsum("iz,ghz->ghi", sel(2, fz, gz), t)


class ZWindow(NamedTuple):
    """A run of the occluder field's Z planes, from a volume that holds a
    run of its own Z planes (a slab and its halo): the whole volume's
    dims, the Z of the held volume's first plane, and the light planes
    [z0, z1) of the whole light grid to make. Coordinates stay the whole
    grid's, so a window's planes are the whole field's bit for bit."""

    volume_dims: tuple
    held_z0: int
    z0: int
    z1: int


def _trilerp_x_first(corner, shift: _Shift):
    """The constant-weight lerp of K3's stride-r walk (any ratio above
    1): along x, then y, then z, the selection matmuls' order."""
    (gx, gy, gz), (fx, fy, fz) = _weights(shift)
    t = {(dy, dz): corner(0, dy, dz) * gx + corner(1, dy, dz) * fx
         for dy in (0, 1) for dz in (0, 1)}
    u0 = t[0, 0] * gy + t[1, 0] * fy
    u1 = t[0, 1] * gy + t[1, 1] * fy
    return u0 * gz + u1 * fz


def _gather_trilinear(volume: torch.Tensor, light_dims, shift: _Shift,
                      window: ZWindow | None = None):
    """:func:`_const_shift_trilinear` as K3's occluder source computes it:
    the corners gathered at clamped indices (what the edge pad holds),
    lerped along z, then y, then x at ratio 1. With a ``window``, the
    light planes it names from the Z planes ``volume`` holds, at any
    integer ratio (lerped along x, then y, then z above ratio 1)."""
    vd = volume.shape if window is None else window.volume_dims
    spans = [(0, light_dims[0]), (0, light_dims[1]),
             (0, light_dims[2]) if window is None
             else (window.z0, window.z1)]
    held0 = 0 if window is None else window.held_z0

    def index(a, d, view):
        i = torch.arange(*spans[a], device=volume.device) * shift.r[a]
        i = (i + (shift.i0[a] - shift.pads[a] + d)).clamp(0, vd[a] - 1)
        return (i - held0 if a == 2 else i).view(view)

    ix = [index(0, d, (-1, 1, 1)) for d in (0, 1)]
    iy = [index(1, d, (1, -1, 1)) for d in (0, 1)]
    iz = [index(2, d, (1, 1, -1)) for d in (0, 1)]
    lerp = _trilerp if all(v == 1 for v in shift.r) else _trilerp_x_first
    return lerp(lambda dx, dy, dz: volume[ix[dx], iy[dy], iz[dz]], shift)


def _light_uvw(light_dims, uvw_offset, device, z_span=None):
    """(uvw (X, Y, Z, 3), res) of the light voxel centers + the offset;
    with ``z_span`` = (z0, z1) only those Z planes of the grid."""
    res = to_device(light_dims, device, torch.float32)
    spans = [(0, light_dims[0]), (0, light_dims[1]),
             z_span or (0, light_dims[2])]
    grids = torch.meshgrid(
        *[torch.arange(*sp, dtype=torch.float32, device=device)
          for sp in spans],
        indexing="ij",
    )
    off = to_device(np.asarray(uvw_offset, np.float32), device)
    return (torch.stack(grids, dim=-1) + 0.5) / res + off, res


def _resample(volume, light_dims, uvw_offset):
    """The occluder's volume samples in differentiable PyTorch."""
    if _const_shift(volume.shape, light_dims, uvw_offset) is not None:
        return _const_shift_trilinear(volume, light_dims, uvw_offset)
    uvw, _ = _light_uvw(light_dims, uvw_offset, volume.device)
    return trilinear_sample(volume, uvw)


def _step(step_size) -> float:
    return float(np.float32(step_size) * np.float32(VOLUME_DENSITY))


def _composed(volume, tf_table, windowing_vec4, light_dims, uvw_offset,
              step_size, clip_center, clip_direction, alpha, parts,
              window: ZWindow | None = None):
    """The occluder field in PyTorch operations, the windowed TF alpha
    through ``alpha``; see :func:`occluder_opacity`."""
    dev = volume.device
    ld = tuple(int(d) for d in light_dims)
    uvw, res = _light_uvw(ld, uvw_offset, dev,
                          None if window is None else window[2:])
    weight = clip_soft_alpha_weight(uvw, clip_center, clip_direction, res)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    if window is not None:
        value = _gather_trilinear(volume, ld, _window_shift(
            window, ld, uvw_offset, volume.shape[2]), window)
    else:
        shift = _const_shift(volume.shape, ld, uvw_offset)
        if shift is None:
            value = trilinear_sample(volume, uvw)
        elif all(v == 1 for v in shift.r):
            value = _gather_trilinear(volume, ld, shift)
        else:
            value = _const_shift_trilinear(volume, ld, uvw_offset)
    opacity = alpha(value, tf_table, windowing_vec4, _step(step_size))
    keep = inside & (weight > 0.0)
    zero = torch.zeros_like(opacity)
    out = torch.where(keep, opacity * weight, zero)
    return (out, value, torch.where(keep, weight, zero)) if parts else out


def _window_shift(window: ZWindow, light_dims, uvw_offset,
                  held: int) -> _Shift:
    """The :class:`_Shift` of a window's field; refuses a ratio that is not
    an integer and a window whose samples leave the ``held`` Z planes."""
    shift = _const_shift(window.volume_dims, light_dims, uvw_offset)
    if shift is None:
        raise ValueError("a Z window needs integer volume/light ratios")
    base = shift.i0[2] - shift.pads[2]
    vz = int(window.volume_dims[2])
    lo = min(max(base + window.z0 * shift.r[2], 0), vz - 1)
    hi = min(max(base + (window.z1 - 1) * shift.r[2] + 1, 0), vz - 1)
    if lo < window.held_z0 or hi >= window.held_z0 + held:
        raise ValueError(f"light planes {window.z0}..{window.z1 - 1} sample "
                         f"volume planes {lo}..{hi}, beyond the {held} held "
                         f"from {window.held_z0}")
    return shift


def occluder_opacity_plain(volume, tf_table, windowing_vec4, light_dims,
                           uvw_offset, step_size, clip_center,
                           clip_direction, parts: bool = False,
                           window: ZWindow | None = None):
    """:func:`occluder_opacity` in plain PyTorch, one operation per step of
    the kernel. The sample: at ratio 1 the kernel's clamped corners and
    lerp order; at integer ratios above 1 the selection matmuls
    (:func:`_const_shift_trilinear`), which the kernel's stride-r walk
    meets within an ulp; at other ratios one trilinear fetch per voxel
    (`trilinear_sample`). The clip weight is
    `sampling.clip_soft_alpha_weight`, whose distance and norm the kernel
    sums in its own order (an ulp of the distance apart). With a
    ``window``, its light planes from the Z planes ``volume`` holds, the
    corners gathered as the kernel gathers them at every integer ratio."""
    return _composed(volume, tf_table, windowing_vec4, light_dims,
                     uvw_offset, step_size, clip_center, clip_direction,
                     windowed_tf_alpha_plain, parts, window)


def _on(x, device) -> bool:
    return isinstance(x, torch.Tensor) and x.device == device


def _floats(x, n: int) -> list:
    """``x`` (numbers, an array or a tensor) as ``n`` float32 values."""
    return torch.as_tensor(x, dtype=torch.float32).detach().cpu().reshape(
        n).tolist()


class _OccluderGeometry(ctypes.Structure):
    """One face's geometry as K3's occluder source reads it (`TbrOccluder`
    in csrc/tf_alpha.cu)."""

    _fields_ = [("vd", ctypes.c_int * 3), ("ld", ctypes.c_int * 3),
                ("base", ctypes.c_int * 3), ("r", ctypes.c_int * 3),
                ("f", ctypes.c_float * 3), ("g", ctypes.c_float * 3),
                ("res", ctypes.c_float * 3), ("off", ctypes.c_float * 3),
                ("clip", ctypes.c_float * 6), ("win", ctypes.c_float * 4),
                ("clip_dev", ctypes.c_void_p),
                ("x_first", ctypes.c_int), ("oz", ctypes.c_int * 2),
                ("vz", ctypes.c_int * 2)]


def occluder_opacity(volume, tf_table, windowing_vec4, light_dims,
                     uvw_offset, step_size, clip_center, clip_direction,
                     parts: bool = False, window: ZWindow | None = None):
    """Occluder opacity of one face (`AddDirLightShader.usf:84-114`): the
    volume sampled at each light voxel center offset toward the light,
    windowed TF alpha, times the soft clip weight; zero where the offset
    sample leaves [0, 1]^3. Returns a ``light_dims`` tensor, with
    ``parts`` also the sampled values and ``keep ? weight : 0`` (the
    backward's inputs).

    For CUDA tensors at integer volume/light ratios one launch of K3's
    occluder source, which reads the volume and writes the opacity (and
    the parts when asked for); the geometry, and a window or clip plane
    given as host data (a CPU tensor too), go by value, and a window or
    clip plane given as tensors on the card is read there, so nothing is
    copied between host and device. At other ratios on the card the
    PyTorch composition with K3 on its values. For CPU tensors
    :func:`occluder_opacity_plain`.

    ``window`` (:class:`ZWindow`, integer ratios only): ``volume`` holds
    the Z planes ``window.held_z0`` onward of a volume of
    ``window.volume_dims`` (a slab and its halo), and the result is the
    field's light planes [``window.z0``, ``window.z1``), (X, Y, z1 - z0):
    one launch of K3 that reads the held planes in place."""
    if volume.device.type == "cpu":
        return occluder_opacity_plain(volume, tf_table, windowing_vec4,
                                      light_dims, uvw_offset, step_size,
                                      clip_center, clip_direction, parts,
                                      window)
    ld = tuple(int(d) for d in light_dims)
    if window is not None:
        shift = _window_shift(window, ld, uvw_offset, volume.shape[2])
        vd, oz = tuple(int(d) for d in window.volume_dims), (
            window.z0, window.z1 - window.z0)
        vz = (window.held_z0, int(volume.shape[2]))
    else:
        shift = _const_shift(volume.shape, ld, uvw_offset)
        vd, oz = tuple(volume.shape), (0, ld[2])
        vz = (0, vd[2])
    if shift is None:
        return _composed(volume, tf_table, windowing_vec4, ld, uvw_offset,
                         step_size, clip_center, clip_direction,
                         tf_alpha.windowed_tf_alpha, parts)
    dev = volume.device
    volume = volume.contiguous()
    tf_table = tf_table.contiguous()
    _kernels.check(volume, "volume", torch.float32, dev)
    _kernels.check(tf_table, "tf_table", torch.float32, dev)
    if tuple(tf_table.shape) != (256, 4):
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    g, f = _weights(shift)
    geo = _OccluderGeometry(
        vd=(ctypes.c_int * 3)(*vd), ld=(ctypes.c_int * 3)(*ld),
        base=(ctypes.c_int * 3)(*(i - p for i, p in zip(shift.i0,
                                                        shift.pads))),
        r=(ctypes.c_int * 3)(*shift.r),
        f=(ctypes.c_float * 3)(*f), g=(ctypes.c_float * 3)(*g),
        res=(ctypes.c_float * 3)(*ld),
        off=(ctypes.c_float * 3)(*np.asarray(uvw_offset, np.float32)),
        x_first=int(any(v != 1 for v in shift.r)),
        oz=(ctypes.c_int * 2)(*oz), vz=(ctypes.c_int * 2)(*vz))
    # host data goes by value: an upload would wait for the queued work
    win = clip = None
    if _on(windowing_vec4, dev):
        win = _kernels.window_tensor(windowing_vec4, dev).contiguous()
    else:
        geo.win[:] = _floats(windowing_vec4, 4)
    if _on(clip_center, dev) and _on(clip_direction, dev):
        clip = torch.cat([c.to(torch.float32).reshape(3)
                          for c in (clip_center, clip_direction)])
        geo.clip_dev = clip.data_ptr()
    else:
        geo.clip[:] = _floats(clip_center, 3) + _floats(clip_direction, 3)
    out = torch.empty((ld[0], ld[1], oz[1]), dtype=torch.float32,
                      device=dev)
    values = torch.empty_like(out) if parts else None
    keep_weight = torch.empty_like(out) if parts else None
    _kernels.launch(
        "tbr_occluder_alpha", volume.data_ptr(), tf_table.data_ptr(),
        None if win is None else win.data_ptr(), ctypes.addressof(geo),
        out.data_ptr(),
        values.data_ptr() if parts else None,
        keep_weight.data_ptr() if parts else None, _step(step_size),
        _kernels.stream_of(volume),
    )
    occluder_opacity.launches += 1
    return (out, values, keep_weight) if parts else out


occluder_opacity.launches = 0


class _OccluderOpacity(torch.autograd.Function):
    """Forward :func:`occluder_opacity` (K3's occluder source), backward
    `tf_alpha.windowed_tf_alpha_bwd` (K8) on the sampled values with the
    cotangent times ``keep ? weight : 0``, both looked up at call time; the
    volume's cotangent, only when it is asked for, is the adjoint of
    :func:`_resample`. The parts are kept only when a gradient is asked
    for."""

    @staticmethod
    def forward(ctx, volume, tf_table, windowing_vec4, face):
        parts = any(ctx.needs_input_grad[:3])
        got = occluder_opacity(volume, tf_table, windowing_vec4, *face,
                               parts=parts)
        if not parts:
            return got
        out, values, keep_weight = got
        ctx.face = face
        win = windowing_vec4 if isinstance(windowing_vec4,
                                           torch.Tensor) else None
        ctx.host_window = windowing_vec4 if win is None else None
        ctx.save_for_backward(volume, tf_table, win, values, keep_weight)
        return out

    @staticmethod
    def backward(ctx, g):
        volume, tf_table, win, values, keep_weight = ctx.saved_tensors
        if win is None:
            win = ctx.host_window
        light_dims, uvw_offset, step_size = ctx.face[:3]
        with span(TF_ALPHA_BWD):
            dval, dtf, dwin = tf_alpha.windowed_tf_alpha_bwd(
                values, tf_table, win, _step(step_size), g * keep_weight)
        dvol = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                v = volume.detach().requires_grad_()
                (dvol,) = torch.autograd.grad(
                    _resample(v, light_dims, uvw_offset), v, dval)
        # a window tensor takes its gradient on its own device
        dwin = dwin.to(win.device) if ctx.needs_input_grad[2] else None
        return dvol, dtf.to(tf_table.dtype), dwin, None


def occluder_opacity_volume(volume, tf_table, windowing_vec4, light_dims,
                            uvw_offset, step_size, clip_center,
                            clip_direction):
    """Differentiable :func:`occluder_opacity`: gradients flow to the
    volume, the TF table's alpha column and the window (kernel K8 and the
    resample's adjoint; a window given as a tensor takes one). Returns a
    ``light_dims`` tensor."""
    with span(OCCLUDER):
        face = (tuple(int(d) for d in light_dims), uvw_offset, step_size,
                clip_center, clip_direction)
        return _OccluderOpacity.apply(volume, tf_table, windowing_vec4, face)


def _propagate_one_face(volume, tf_table, windowing_vec4, clip_center,
                        clip_direction, uv_off, uvw_off, step_size,
                        light_alpha, face: int, light_dims,
                        apply_write_threshold: bool = True):
    """Transmitted light of one face's share of a light, shape
    ``light_dims``: occluder field, transpose so propagation is the scan
    axis, flip so the scan walks slice 0 -> N-1, scan (kernels K4/K7),
    threshold, and undo the flip and transpose. ``light_alpha`` is a
    number or a 0-d tensor."""
    opacity = occluder_opacity_volume(
        volume, tf_table, windowing_vec4, light_dims, uvw_off, step_size,
        clip_center, clip_direction,
    )
    return scan_one_face(opacity, uv_off, light_alpha, face, light_dims,
                         apply_write_threshold)


def scan_one_face(opacity, uv_off, light_alpha, face: int, light_dims,
                  apply_write_threshold: bool = True):
    """The transmitted light of one face from its ``light_dims`` occluder
    field: the second half of :func:`_propagate_one_face`."""
    with span(LIGHT_SCAN, face):
        ax = transposed_axes(face)
        tdims = (light_dims[ax[0]], light_dims[ax[1]], light_dims[ax[2]])
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
