"""K9: the fused lit ray march, with its host glue.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_march.py::
march_lit_pallas`, without the TPU's pencil swizzle, DMA windows and
window choice: the Hopper kernel (`csrc/march.cu`) reads the volume and the
light volume in place and has no window limit. The glue computes each ray's
start, step vector, number of full steps and final fraction with the
march's own arithmetic (`march._march_state`) and lays them out as
(8, H, W) fields, and :func:`march_lit_fused` launches the kernel on them
for CUDA tensors; for CPU tensors it runs :func:`march_lit_fused_plain`.

The kernel is forward-only, as in the JAX package: :func:`march_lit_fused`
raises when autograd would record a gradient, rather than return a frame
whose gradient is silently zero. Differentiate through
`march.march_lit_blocked` or `march.march_lit` instead.

The semantics are `march.march_lit`'s with the sample positions of
`march.march_lit_blocked` (``pos0 + step_vec * (k + 1)``, not a running
sum), so the two agree to float rounding; the plain version does the
kernel's operations in the kernel's order.
"""

from __future__ import annotations

import torch

from ..utils.device import to_device
from ..utils.profiling import MARCH, span
from . import _kernels
from .compositing import EARLY_TERMINATION_ALPHA
from .march import _loop_bound, _march_state
from .rays import RayBatch
from .sampling import VOLUME_DENSITY, trilinear_sample


def _march_inputs(volume, rays: RayBatch, windowing_vec4, clip_center,
                  clip_direction, jitter, step_count: int):
    """(ch, params): the (8, H, W) per-ray fields (start xyz, step vector
    xyz, n_full, final_frac) and the (10,) window (4), clip center (3) and
    clip direction (3), both float32 on the volume's device."""
    if rays.thickness.dim() != 2:
        raise ValueError("the fused march takes an (H, W) ray batch, got "
                         f"{tuple(rays.thickness.shape)}")
    dev = volume.device
    st = _march_state(rays, step_count, jitter)
    ch = torch.stack([st.pos0[..., 0], st.pos0[..., 1], st.pos0[..., 2],
                      st.step_vec[..., 0], st.step_vec[..., 1],
                      st.step_vec[..., 2], st.n_full, st.final_frac])
    params = torch.cat([
        _kernels.window_tensor(windowing_vec4, dev),
        to_device(clip_center, dev, torch.float32).reshape(3),
        to_device(clip_direction, dev, torch.float32).reshape(3),
    ])
    return ch.to(dev, torch.float32).contiguous(), params.contiguous()


def _plain_sample(volume, tf_table, light_volume, params, px, py, pz, sw):
    """The kernel's `lit_sample` over all rays: (clipped, cut, r, g, b,
    alpha), rgb times light; a clipped or cut sample adds nothing."""
    center, width, low_c, high_c = params[0], params[1], params[2], params[3]
    ccx, ccy, ccz, cdx, cdy, cdz = params[4:10]
    dot = (px - ccx) * cdx + (py - ccy) * cdy + (pz - ccz) * cdz
    value = trilinear_sample(volume, torch.stack([px, py, pz], -1))
    tf_pos = (value - center + width * 0.5) / width
    cut = ((tf_pos < 0.0) & (low_c > 0.0)) | ((tf_pos > 1.0) & (high_c > 0.0))
    x = tf_pos * 256.0 - 0.5
    i0f = torch.floor(x)
    frac = (x - i0f)[..., None]
    i0f = i0f.nan_to_num(0.0)  # the kernel's fmaxf takes a NaN tap to 0
    c0 = tf_table[i0f.clamp(0.0, 255.0).long()]
    c1 = tf_table[(i0f + 1.0).clamp(0.0, 255.0).long()]
    c = c0 + (c1 - c0) * frac
    ca = c[..., 3].clamp(0.0, 1.0)
    a = 1.0 - torch.exp(sw * torch.log(torch.clamp(1.0 - ca, min=1e-10)))
    light = trilinear_sample(light_volume, torch.stack(
        [px.clamp(0.0, 1.0), py.clamp(0.0, 1.0), pz.clamp(0.0, 1.0)], -1))
    return (dot <= 0.0, cut, c[..., 0] * light, c[..., 1] * light,
            c[..., 2] * light, a)


def _cells_occupied(occupancy, px, py, pz) -> torch.Tensor:
    """The occupancy grid's cell of each position, as the kernel reads it:
    ``floor(p * cell_scale)`` per axis, clamped to the grid (a NaN to 0)."""
    grid = occupancy.grid
    idx = [torch.floor(p * float(s)).nan_to_num(0.0).clamp(0, n - 1).long()
           for p, s, n in zip((px, py, pz), occupancy.cell_scale, grid.shape)]
    return grid[idx[0], idx[1], idx[2]]


def _per_warp_max_sum(counts: torch.Tensor) -> int:
    """Sum over the kernel's warps (tiles of 4 rows of 8 pixels in a 16x16
    block) of 32 times the warp's largest per-ray count of the (H, W)
    ``counts``."""
    h, w = counts.shape
    c = torch.nn.functional.pad(counts, (0, -w % 8, 0, -h % 4))
    return 32 * int(c.reshape(c.shape[0] // 4, 4, c.shape[1] // 8, 8)
                    .amax(dim=(1, 3)).sum())


def _march_plain(ch, volume, light_volume, tf_table, params,
                 step_count: int, early_termination: float,
                 compat_final_step: bool, stats: dict | None = None,
                 occupancy=None) -> torch.Tensor:
    """The kernel's march over the (8, H, W) fields ``ch`` -> (H, W, 4),
    one PyTorch operation per step of the kernel, all rays at once, with
    masks in place of the kernel's per-ray loop bound and exit. A sample in
    a cell that ``occupancy`` marks empty is skipped, as the kernel skips
    it; its alpha is 0, so it would add exactly nothing. ``stats``, when
    given, receives the work the kernel does on these inputs (see
    :func:`march_lit_fused_plain`)."""
    p0x, p0y, p0z, svx, svy, svz, n_full, ff = ch.unbind(0)
    step_world = VOLUME_DENSITY * (1.0 / step_count)
    rr, rg, rb, alpha = (torch.zeros_like(n_full) for _ in range(4))
    term = torch.zeros_like(n_full, dtype=torch.bool)
    one = torch.ones_like(alpha)
    keys = ("steps", "samples", "shaded", "fetches", "cut", "zero_alpha")
    if occupancy is not None:
        keys += ("empty",)
    count = (None if stats is None else
             {k: torch.zeros_like(n_full, dtype=torch.int32) for k in keys})

    def composite(live, pos, sw):
        clipped, cut, cr, cg, cb, a = _plain_sample(
            volume, tf_table, light_volume, params, *pos, sw)
        fetch = live & ~clipped
        if occupancy is not None:
            occupied = _cells_occupied(occupancy, *pos)
            if stats is not None:
                count["empty"] += fetch & ~occupied
            fetch = fetch & occupied
        m = fetch & ~cut
        trans = 1.0 - alpha
        if stats is not None:
            count["steps"] += live
            count["samples"] += live & ~clipped & ~cut  # the bound's counts
            count["shaded"] += live & ~clipped & ~cut & (a > 0.0)
            count["fetches"] += fetch
            count["cut"] += fetch & cut
            count["zero_alpha"] += m & (a == 0.0)
        return (m, torch.where(m, rr + cr * a * trans, rr),
                torch.where(m, rg + cg * a * trans, rg),
                torch.where(m, rb + cb * a * trans, rb),
                torch.where(m, alpha + a * trans, alpha))

    for k in range(_loop_bound(n_full, step_count)):
        kk = float(k + 1)
        live = (k < n_full) & ~term
        m, rr, rg, rb, alpha = composite(
            live, (p0x + svx * kk, p0y + svy * kk, p0z + svz * kk),
            step_world)
        hit = m & (alpha > early_termination)  # the snap ends the ray
        alpha = torch.where(hit, one, alpha)
        term = term | hit
        if k % 16 == 15 and not bool(((k + 1 < n_full) & ~term).any()):
            break  # every ray is done: the kernel's threads have all exited
    kk = n_full + ff
    sw = VOLUME_DENSITY * ff if compat_final_step else step_world * ff
    m, rr, rg, rb, alpha = composite(
        ~term & (ff > 0.0), (p0x + svx * kk, p0y + svy * kk, p0z + svz * kk),
        sw)
    if stats is not None:
        stats.update({k: int(v.sum()) for k, v in count.items()})
        for k in ("steps", "samples", "fetches"):
            stats["warp_" + k] = _per_warp_max_sum(count[k])
    return torch.stack([rr, rg, rb, alpha], -1)


def march_lit_fused_plain(volume, tf_table, light_volume, rays: RayBatch,
                          windowing_vec4, clip_center, clip_direction,
                          jitter=None, step_count: int = 150,
                          early_termination: float = EARLY_TERMINATION_ALPHA,
                          compat_final_step: bool = True, occupancy=None,
                          stats: dict | None = None) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch; see :func:`march_lit_fused`.

    ``stats``, when given, receives the kernel's work on these inputs, as
    counts of samples: ``"steps"``, those its threads take (every step up to
    a ray's termination or exit, and the final fractional sample of a ray
    that did not terminate); ``"samples"``, those of them that are neither
    clipped nor cut, which the bound charges with a fetch and a lookup;
    ``"shaded"``, those of them whose alpha is above 0, which it also
    charges with the light and the composite; ``"fetches"``, those whose
    volume the kernel reads (not clipped, and with ``occupancy`` not in an
    empty cell; ``"empty"`` counts the latter); of these ``"cut"``, cut by
    the window, and
    ``"zero_alpha"``, composited with alpha 0. ``"warp_steps"``,
    ``"warp_samples"`` and ``"warp_fetches"`` sum over the kernel's warps 32
    times the warp's largest per-ray count: the lane slots a warp issues
    while its longest ray runs."""
    ch, params = _march_inputs(volume, rays, windowing_vec4, clip_center,
                               clip_direction, jitter, step_count)
    return _march_plain(ch, volume, light_volume, tf_table, params,
                        step_count, early_termination, compat_final_step,
                        stats, occupancy)


def march_lit_fused(volume, tf_table, light_volume, rays: RayBatch,
                    windowing_vec4, clip_center, clip_direction, jitter=None,
                    step_count: int = 150,
                    early_termination: float = EARLY_TERMINATION_ALPHA,
                    compat_final_step: bool = True,
                    occupancy=None) -> torch.Tensor:
    """The lit march of an (H, W) ray batch -> (H, W, 4) RGBA (the
    arguments of `march.march_lit`): K9 for CUDA tensors,
    :func:`march_lit_fused_plain` for CPU tensors. Forward only.

    ``occupancy``: an `octree.OccupancyGrid` of this volume, window and TF
    (`octree.occupancy_grid`, whose ranges `octree.LERP_MARGIN` widens);
    the march skips the samples in the cells it marks empty, which changes
    no bit of the frame."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (volume, tf_table, light_volume, windowing_vec4,
                      *rays, jitter)):
        raise RuntimeError(
            "march_lit_fused (kernel K9) is forward-only: an input requires "
            "grad. Run it under torch.no_grad(), or differentiate through "
            "march.march_lit_blocked or march.march_lit.")
    args = (volume, tf_table, light_volume, rays, windowing_vec4, clip_center,
            clip_direction, jitter, step_count, early_termination,
            compat_final_step, occupancy)
    with span(MARCH):
        if volume.device.type == "cpu":
            return march_lit_fused_plain(*args)
        dev = volume.device
        ch, params = _march_inputs(volume, *args[3:9])
        volume, light_volume = volume.contiguous(), light_volume.contiguous()
        tf_table = tf_table.contiguous()
        for name, t in dict(volume=volume, light_volume=light_volume,
                            tf_table=tf_table).items():
            _kernels.check(t, name, torch.float32, dev)
        if tuple(tf_table.shape) != (256, 4):
            raise ValueError(
                f"tf_table must be (256, 4), got {tf_table.shape}")
        if volume.dim() != 3 or light_volume.dim() != 3:
            raise ValueError("volume and light_volume must be 3-D")
        grid, scale = None, (0.0, 0.0, 0.0)
        if occupancy is not None:
            grid, scale = occupancy.grid.contiguous(), occupancy.cell_scale
            _kernels.check(grid, "occupancy grid", torch.bool, dev)
            if grid.dim() != 3:
                raise ValueError("the occupancy grid must be 3-D")
        _, h, w = ch.shape
        out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
        _kernels.launch(
            "tbr_march", ch.data_ptr(), volume.data_ptr(),
            light_volume.data_ptr(), tf_table.data_ptr(), params.data_ptr(),
            None if grid is None else grid.data_ptr(), out.data_ptr(), h, w,
            *volume.shape, *light_volume.shape,
            *(grid.shape if grid is not None else (0, 0, 0)),
            VOLUME_DENSITY * (1.0 / step_count), VOLUME_DENSITY,
            float(early_termination), *(float(x) for x in scale),
            int(bool(compat_final_step)), _kernels.stream_of(ch),
        )
    march_lit_fused.launches += 1
    return out


march_lit_fused.launches = 0
