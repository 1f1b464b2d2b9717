"""The reference's lit ray march: camera rays into the volume's UVW space
and the front-to-back march with early termination, in plain PyTorch.

Frozen copies of `tbraymarcherplugin_tpu_torch/ops/rays.py` (`camera_rays`,
`setup_rays` without a scene depth) and of K9's plain version in
`ops/fused_march.py` (`_march_plain`, `_plain_sample`, with the start
state of `ops/march.py::_march_state`), without empty-space skipping: the
skip changes no bit of a frame, so the reference marches every step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .common import (VOLUME_DENSITY, clip01, lookup, step_alpha, tf_taps,
                     trilinear_sample)

SQRT_3 = math.sqrt(3.0)


class RayBatch(NamedTuple):
    """Rays in UVW space: (..., 3) entry and unit direction, (...,)
    entry-to-exit thickness."""

    entry: torch.Tensor
    direction: torch.Tensor
    thickness: torch.Tensor


def camera_rays(camera, width: int, height: int, device=None):
    """World-space (H, W, 3) origins and unit directions through every
    pixel center; pixel (0, 0) is top-left."""
    f32 = torch.float32
    aspect = height / width
    t = float(camera.tan_half_fov)
    xs = (torch.arange(width, dtype=f32, device=device) + 0.5) / width
    xs = xs * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=f32, device=device) + 0.5) \
        / height * 2.0
    px, py = torch.meshgrid(xs * t, ys * t * aspect, indexing="xy")
    rot = torch.as_tensor(camera.rotation, device=device)
    dirs = px[..., None] * rot[0] + py[..., None] * rot[1] + rot[2]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origins = torch.as_tensor(camera.position,
                              device=device).expand(dirs.shape)
    return origins, dirs


def setup_rays(camera, transform, width: int, height: int,
               device=None) -> RayBatch:
    """World rays -> UVW entry, local unit direction and thickness, the
    entry clamped in front of the camera."""
    origins_w, dirs_w = camera_rays(camera, width, height, device)
    rot = torch.as_tensor(transform.rotation, device=device)
    trans = torch.as_tensor(transform.translation, device=device)
    scale = torch.as_tensor(transform.scale, device=device)
    origin = ((origins_w - trans) @ rot.T) / scale + 0.5
    dirs = (dirs_w @ rot.T) / scale
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    inv = 1.0 / dirs
    t_a, t_b = (0.0 - origin) * inv, (1.0 - origin) * inv
    t0 = torch.minimum(t_a, t_b).amax(-1).clamp(min=0.0)
    t1 = torch.maximum(t_a, t_b).amin(-1)
    thickness = (t1 - t0).clamp(min=0.0)
    return RayBatch(origin + t0[..., None] * dirs, dirs, thickness)


def _lit_sample(volume, table, light_volume, win, clip_center,
                clip_direction, px, py, pz, sw):
    """(clipped, cut, r, g, b, alpha) of the samples at (px, py, pz):
    rgb times the light sampled at the clamped position."""
    ccx, ccy, ccz = (float(x) for x in clip_center)
    cdx, cdy, cdz = (float(x) for x in clip_direction)
    dot = (px - ccx) * cdx + (py - ccy) * cdy + (pz - ccz) * cdz
    value = trilinear_sample(volume, torch.stack([px, py, pz], -1))
    _, cut, i0, i1, frac = tf_taps(value, win)
    frac = frac[..., None]
    c0, c1 = lookup(table, i0), lookup(table, i1)
    c = c0 + (c1 - c0) * frac
    a = step_alpha(clip01(c[..., 3]), sw)
    light = trilinear_sample(light_volume, torch.stack(
        [px.clamp(0.0, 1.0), py.clamp(0.0, 1.0), pz.clamp(0.0, 1.0)], -1))
    return (dot <= 0.0, cut, c[..., 0] * light, c[..., 1] * light,
            c[..., 2] * light, a)


def march_lit(volume, table, light_volume, rays: RayBatch, win, clip_center,
              clip_direction, jitter=None, step_count: int = 150,
              early_termination: float = 0.95,
              compat_final_step: bool = True,
              stats: dict | None = None) -> torch.Tensor:
    """The lit march of an (H, W) ray batch -> (H, W, 4) RGBA: K9's
    operations in its order, all rays at once, masks in place of the
    per-ray loop bound and exit; ``win`` holds (center, width, low, high)
    as floats.

    ``stats``, when given, receives the work these inputs need, as counts
    of samples: ``steps`` (every step up to a ray's termination or exit,
    and the final fractional sample of a ray that did not terminate),
    ``samples`` (those neither clipped nor cut) and ``shaded`` (those of
    them whose alpha is above 0)."""
    step_size = 1.0 / step_count
    step_vec = rays.direction * step_size
    float_actual = step_count * rays.thickness
    n_full = torch.floor(float_actual)
    ff = float_actual - n_full
    pos0 = rays.entry
    if jitter is not None:
        pos0 = pos0 - step_vec * jitter[..., None]
    p0x, p0y, p0z = pos0.unbind(-1)
    svx, svy, svz = step_vec.unbind(-1)
    step_world = VOLUME_DENSITY * (1.0 / step_count)
    rr, rg, rb, alpha = (torch.zeros_like(n_full) for _ in range(4))
    term = torch.zeros_like(n_full, dtype=torch.bool)
    one = torch.ones_like(alpha)
    counts = {k: 0 for k in ("steps", "samples", "shaded")}

    def composite(live, pos, sw):
        clipped, cut, cr, cg, cb, a = _lit_sample(
            volume, table, light_volume, win, clip_center, clip_direction,
            *pos, sw)
        m = live & ~clipped & ~cut
        trans = 1.0 - alpha
        if stats is not None:
            counts["steps"] += int(live.sum())
            counts["samples"] += int(m.sum())
            counts["shaded"] += int((m & (a > 0.0)).sum())
        return (m, torch.where(m, rr + cr * a * trans, rr),
                torch.where(m, rg + cg * a * trans, rg),
                torch.where(m, rb + cb * a * trans, rb),
                torch.where(m, alpha + a * trans, alpha))

    longest = float(torch.nan_to_num(n_full, nan=0.0).max()) \
        if n_full.numel() else 0.0
    bound = min(int(math.ceil(step_count * SQRT_3)), max(int(longest), 0))
    for k in range(bound):
        kk = float(k + 1)
        live = (k < n_full) & ~term
        m, rr, rg, rb, alpha = composite(
            live, (p0x + svx * kk, p0y + svy * kk, p0z + svz * kk),
            step_world)
        hit = m & (alpha > early_termination)
        alpha = torch.where(hit, one, alpha)
        term = term | hit
        if k % 16 == 15 and not bool(((k + 1 < n_full) & ~term).any()):
            break
    kk = n_full + ff
    sw = VOLUME_DENSITY * ff if compat_final_step else step_world * ff
    m, rr, rg, rb, alpha = composite(
        ~term & (ff > 0.0), (p0x + svx * kk, p0y + svy * kk, p0z + svz * kk),
        sw)
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v
    return torch.stack([rr, rg, rb, alpha], -1)
