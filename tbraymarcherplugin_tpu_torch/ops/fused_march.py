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
        torch.as_tensor(clip_center, dtype=torch.float32, device=dev)
        .reshape(3),
        torch.as_tensor(clip_direction, dtype=torch.float32, device=dev)
        .reshape(3),
    ])
    return ch.to(dev, torch.float32).contiguous(), params.contiguous()


def _plain_sample(volume, tf_table, light_volume, params, px, py, pz, sw):
    """The kernel's `lit_sample` over all rays: (contributes, r, g, b,
    alpha), rgb times light; masked samples add nothing."""
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
    ok = ~(dot <= 0.0) & ~cut
    return ok, c[..., 0] * light, c[..., 1] * light, c[..., 2] * light, a


def _march_plain(ch, volume, light_volume, tf_table, params,
                 step_count: int, early_termination: float,
                 compat_final_step: bool, stats: dict | None = None
                 ) -> torch.Tensor:
    """The kernel's march over the (8, H, W) fields ``ch`` -> (H, W, 4),
    one PyTorch operation per step of the kernel, all rays at once, with
    masks in place of the kernel's per-ray loop bound and exit. ``stats``,
    when given, receives the work the kernel does on these inputs (see
    :func:`march_lit_fused_plain`)."""
    p0x, p0y, p0z, svx, svy, svz, n_full, ff = ch.unbind(0)
    step_world = VOLUME_DENSITY * (1.0 / step_count)
    rr, rg, rb, alpha = (torch.zeros_like(n_full) for _ in range(4))
    term = torch.zeros_like(n_full, dtype=torch.bool)
    one = torch.ones_like(alpha)
    steps = samples = 0

    def composite(m, sample):
        ok, cr, cg, cb, a = sample
        m = m & ok
        trans = 1.0 - alpha
        return (m, torch.where(m, rr + cr * a * trans, rr),
                torch.where(m, rg + cg * a * trans, rg),
                torch.where(m, rb + cb * a * trans, rb),
                torch.where(m, alpha + a * trans, alpha))

    for k in range(_loop_bound(n_full, step_count)):
        kk = float(k + 1)
        live = (k < n_full) & ~term
        m, rr, rg, rb, alpha = composite(
            live,
            _plain_sample(volume, tf_table, light_volume, params,
                          p0x + svx * kk, p0y + svy * kk, p0z + svz * kk,
                          step_world))
        if stats is not None:
            steps = steps + live.sum()
            samples = samples + m.sum()
        hit = m & (alpha > early_termination)  # the snap ends the ray
        alpha = torch.where(hit, one, alpha)
        term = term | hit
        if k % 16 == 15 and not bool(((k + 1 < n_full) & ~term).any()):
            break  # every ray is done: the kernel's threads have all exited
    kk = n_full + ff
    sw = VOLUME_DENSITY * ff if compat_final_step else step_world * ff
    live = ~term & (ff > 0.0)
    m, rr, rg, rb, alpha = composite(
        live,
        _plain_sample(volume, tf_table, light_volume, params,
                      p0x + svx * kk, p0y + svy * kk, p0z + svz * kk, sw))
    if stats is not None:
        stats["steps"] = int(steps + live.sum())
        stats["samples"] = int(samples + m.sum())
    return torch.stack([rr, rg, rb, alpha], -1)


def march_lit_fused_plain(volume, tf_table, light_volume, rays: RayBatch,
                          windowing_vec4, clip_center, clip_direction,
                          jitter=None, step_count: int = 150,
                          early_termination: float = EARLY_TERMINATION_ALPHA,
                          compat_final_step: bool = True,
                          stats: dict | None = None) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch; see :func:`march_lit_fused`.

    ``stats``, when given, receives the kernel's work on these inputs:
    ``"steps"``, the samples its threads take (every step up to a ray's
    termination or exit, and the final fractional sample of a ray that did
    not terminate), and ``"samples"``, those of them that are neither
    clipped nor cut and so are looked up, lit and composited."""
    ch, params = _march_inputs(volume, rays, windowing_vec4, clip_center,
                               clip_direction, jitter, step_count)
    return _march_plain(ch, volume, light_volume, tf_table, params,
                        step_count, early_termination, compat_final_step,
                        stats)


def march_lit_fused(volume, tf_table, light_volume, rays: RayBatch,
                    windowing_vec4, clip_center, clip_direction, jitter=None,
                    step_count: int = 150,
                    early_termination: float = EARLY_TERMINATION_ALPHA,
                    compat_final_step: bool = True) -> torch.Tensor:
    """The lit march of an (H, W) ray batch -> (H, W, 4) RGBA (the
    arguments of `march.march_lit`): K9 for CUDA tensors,
    :func:`march_lit_fused_plain` for CPU tensors. Forward only."""
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
            compat_final_step)
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
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    if volume.dim() != 3 or light_volume.dim() != 3:
        raise ValueError("volume and light_volume must be 3-D")
    _, h, w = ch.shape
    out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    _kernels.launch(
        "tbr_march", ch.data_ptr(), volume.data_ptr(),
        light_volume.data_ptr(), tf_table.data_ptr(), params.data_ptr(),
        out.data_ptr(), h, w, *volume.shape, *light_volume.shape,
        VOLUME_DENSITY * (1.0 / step_count), VOLUME_DENSITY,
        float(early_termination), int(bool(compat_final_step)),
        _kernels.stream_of(ch),
    )
    march_lit_fused.launches += 1
    return out


march_lit_fused.launches = 0
