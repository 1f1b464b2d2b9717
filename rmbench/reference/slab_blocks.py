"""The reference for a sharded configuration whose volume no card holds as
float32: `frame.py`'s semantics worked out block by block from the volume
source (`volumes.VolumeSource`). A configuration names it with
``"reference": "slab_blocks"``.

The volume is kept as uint8, made from the source in Z blocks, which is
exact where every value is k / 255 (a uint8 dataset's; refused
otherwise): a quarter of float32's bytes, and each block or plane read
from it is converted back to the same float32 values. The light volume
is float32, full resolution, made face by face:

- a face's occluder field is worked out for a block of its slices at a
  time (`lighting.occluder_opacity_volume`'s arithmetic on the block's
  light voxels, the corners gathered at clamped indices, which is what
  the edge-padded shifted slices hold), and its slices are scanned in
  the face's propagation order with the carry passed from block to
  block (`lighting.propagate_face_scan_plain`'s step): the -Z face
  through Z blocks in order, the X face slice by slice, each slice
  needing every Z row;
- each face's light, gated by the write threshold, adds into the light
  volume as `lighting.compute_light_contribution` sums it (one light:
  the contributions of several would need a second volume).

A frame is `frame.py`'s shear-warp frame (`shearwarp.prepare`,
`composite_plain`, the screen warp) with the volume's planes taken from
the uint8 volume. Nothing here imports the program; the check sets TF32
off and runs this on rank 0's card after the program's state is freed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import frame as F
from . import lighting as RL
from . import shearwarp as RSW
from .common import (VOLUME_DENSITY, clip_soft_alpha_weight,
                     windowed_tf_alpha)
from .scene import DirLight

BLOCK = 16  # Z planes made or slices scanned at a time
# the splits of the intermediate image's columns whose first band a traced
# frame's counts also give (a sharded frame's rank 0 composites it)
BANDS = (2, 4)


@functools.lru_cache(maxsize=1)
def _uint8(source, device) -> torch.Tensor:
    """The whole volume as uint8 (X, Y, Z) on ``device``, made from the
    source in Z blocks."""
    dims = tuple(int(d) for d in source.shape)
    out = torch.empty(dims, dtype=torch.uint8, device=device)
    for a in range(0, dims[2], BLOCK):
        b = min(a + BLOCK, dims[2])
        v = source.make(device, z=(a, b))
        q = torch.round(v * 255.0)
        if not torch.equal(q / 255.0, v):
            raise ValueError("slab_blocks keeps the volume as uint8: every "
                             "value must be k / 255")
        out[:, :, a:b] = q.to(torch.uint8)
        del v, q
    return out


def _float(u8: torch.Tensor) -> torch.Tensor:
    return u8.to(torch.float32) / 255.0


class _Planes:
    """The uint8 volume as `shearwarp.prepare` reads a float32 one: its
    shape and device, and an axis permutation whose indexing gives float32
    slices (k / 255, the float32 volume's values)."""

    def __init__(self, u8: torch.Tensor, perm=None):
        self.u8 = u8 if perm is None else u8.permute(perm)
        self.shape = tuple(self.u8.shape)
        self.device = u8.device

    def permute(self, perm):
        return _Planes(self.u8, perm)

    def __getitem__(self, idx):
        return _float(self.u8[idx])


def _window(scene: F.Scene, device) -> torch.Tensor:
    """`frame.Scene.window_tensor` on ``device`` (the scene's volume may be
    a source, which has none)."""
    return torch.tensor([float(np.float32(x)) for x in scene.window],
                        dtype=torch.float32, device=device)


def _volume(scene: F.Scene) -> torch.Tensor:
    if isinstance(scene.volume, torch.Tensor):  # a whole volume (tests)
        q = torch.round(scene.volume * 255.0)
        return q.to(torch.uint8)
    return _uint8(scene.volume, scene.table.device)


def _occluder_block(u8, scene: F.Scene, light_dims, fp, ranges):
    """The occluder opacity of the light voxels ``ranges`` ((lo, hi) per
    axis) of one face: `lighting.occluder_opacity_volume`'s arithmetic at
    full resolution on those voxels."""
    dev = u8.device
    vd = tuple(u8.shape)
    res = torch.tensor(light_dims, dtype=torch.float32, device=dev)
    grids = torch.meshgrid(
        *[torch.arange(lo, hi, dtype=torch.float32, device=dev)
          for lo, hi in ranges], indexing="ij")
    off = torch.as_tensor(np.asarray(fp.uvw_offset, np.float32), device=dev)
    uvw = (torch.stack(grids, dim=-1) + 0.5) / res + off
    clip = scene.local_clip()
    weight = clip_soft_alpha_weight(uvw, clip.center, clip.direction, res)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    del uvw, grids
    # the constant shift of `lighting._const_shift_trilinear` at ratio 1:
    # corner d of light voxel g is volume voxel g + floor(c) + d, clamped
    offv = np.asarray(fp.uvw_offset, np.float32)
    base, frac = [], []
    for a in range(3):
        c = np.float32(0.0) + offv[a] * np.float32(vd[a])
        f = np.floor(c)
        base.append(int(f))
        frac.append(np.float32(c - f))
    one = np.float32(1.0)
    gx, gy, gz = (float(one - f) for f in frac)
    fx, fy, fz = (float(f) for f in frac)

    def index(a, d, view):
        lo, hi = ranges[a]
        i = torch.arange(lo, hi, device=dev) + base[a] + d
        return i.clamp(0, vd[a] - 1).view(view)

    ix = [index(0, d, (-1, 1, 1)) for d in (0, 1)]
    iy = [index(1, d, (1, -1, 1)) for d in (0, 1)]
    iz = [index(2, d, (1, 1, -1)) for d in (0, 1)]

    def corner(dx, dy, dz):
        return _float(u8[ix[dx], iy[dy], iz[dz]])

    c00 = corner(0, 0, 0) * gz + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * gz + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * gz + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * gz + corner(1, 1, 1) * fz
    c0 = c00 * gy + c01 * fy
    c1 = c10 * gy + c11 * fy
    value = c0 * gx + c1 * fx
    del c00, c01, c10, c11, c0, c1
    step = float(np.float32(fp.step_size) * np.float32(VOLUME_DENSITY))
    opacity = windowed_tf_alpha(value, scene.table, _window(scene, dev),
                                step)
    keep = inside & (weight > 0.0)
    return torch.where(keep, opacity * weight, torch.zeros_like(opacity))


def _add_face(lv, u8, scene: F.Scene, fp, light_alpha) -> None:
    """One face's light, gated by the write threshold, added into ``lv``:
    its slices in propagation order, a block of them at a time, the carry
    passed on."""
    dims = tuple(lv.shape)
    axis = RL.face_axis(fp.face)
    bx, by, _ = RL.transposed_axes(fp.face)
    tdims = (dims[bx], dims[by], dims[axis])
    uv = np.asarray(fp.uv_offset, np.float32)
    off_px = uv[0] * np.float32(tdims[0])
    off_py = uv[1] * np.float32(tdims[1])
    alpha = RL._alpha_tensor(light_alpha, lv.device)
    carry = alpha.expand(tdims[0], tdims[1])
    n = dims[axis]
    order = range(0, n, BLOCK)
    if RL.face_direction(fp.face) == -1:
        order = reversed(order)
    for a in order:
        b = min(a + BLOCK, n)
        ranges = [(0, d) for d in dims]
        ranges[axis] = (a, b)
        opac = _occluder_block(u8, scene, dims, fp, ranges).permute(
            axis, bx, by)  # (slices, buffer x, buffer y)
        ks = range(b - a)
        if RL.face_direction(fp.face) == -1:
            ks = reversed(ks)
        for k in ks:
            prev = RL.shift_2d_bilinear_border(carry, off_px, off_py, alpha)
            carry = prev * (1.0 - opac[k])
            light = torch.where(carry.abs() > RL.WRITE_SKIP_THRESHOLD,
                                carry, torch.zeros_like(carry))
            idx = [slice(None)] * 3
            idx[axis] = a + k
            lv[tuple(idx)] += light  # (buffer x, buffer y): volume order
        del opac


def illumination(scene: F.Scene) -> torch.Tensor:
    """The light volume of the scene's one light (a full rebuild, full
    resolution, 32-bit, the write threshold applied), face by face."""
    if len(scene.lights) != 1:
        raise ValueError("slab_blocks rebuilds one light: several would "
                         "need a second volume for their contributions")
    u8 = _volume(scene)
    dims = tuple(u8.shape)
    (d, intensity), = scene.lights
    local = scene.transform.local_light_direction(DirLight.create(d,
                                                                  intensity))
    local = np.asarray(local, np.float64)
    local = local / np.linalg.norm(local)
    axes = RL.local_light_major_axes(local)
    lv = torch.zeros(dims, dtype=torch.float32, device=u8.device)
    for face, weight in zip(axes.faces, axes.weights):
        if weight == 0.0:
            continue
        fp = RL.plan_face_propagation(face, -local, dims, weight)
        _add_face(lv, u8, scene, fp,
                  np.float32(np.float32(intensity) * np.float32(weight)))
    return lv


def plan(scene: F.Scene, camera):
    shape = tuple(scene.volume.shape)
    return RSW.plan_shearwarp(camera, scene.transform, shape, shape,
                              scene.width, scene.height,
                              max_planes=scene.step_count)


def frame(scene: F.Scene, camera, light_volume: torch.Tensor,
          frame_index: int, plane_dtype=torch.float32,
          stats: dict | None = None, storage_dtype=None) -> torch.Tensor:
    """`frame.frame`'s shear-warp frame, the volume's planes taken from
    the uint8 volume (a march frame is refused: the configuration's
    camera is outside the volume)."""
    p = plan(scene, camera)
    if p is None:
        raise ValueError("slab_blocks renders shear-warp frames only")
    dev = light_volume.device
    clip = scene.local_clip()
    win = _window(scene, dev)
    jitter = (F.jitter_values(p.n2, p.n1, frame_index, device=dev)
              if scene.jitter else None)
    kw = RSW.prepare(_Planes(_volume(scene)), scene.table, light_volume, p,
                     win, clip.center, clip.direction, jitter,
                     scene.early_termination, plane_dtype)
    inter = RSW.composite_plain(**kw, stats=stats)
    if stats is not None:
        stats["bands"] = {n: _band_counts(kw, p.n2 // n) for n in BANDS
                          if p.n2 % n == 0}
    return RSW.intermediate_to_screen(inter, p, scene.width, scene.height)


def _band_counts(kw: dict, nb: int) -> dict:
    """The composite's counts of work in the intermediate image's first
    ``nb`` columns (rank 0's band of a split of its columns): the same
    composite on those columns, whose in-cube test counts from column 0
    as the whole image's does."""
    band = dict(kw)
    for k in ("W", "L"):
        band[k] = kw[k][..., :nb]
    for k in ("e1", "step_world", "jitter"):
        if band[k] is not None:
            band[k] = kw[k][:, :nb]
    counts = {}
    RSW.composite_plain(**band, stats=counts)
    return counts
