"""K1: the fused shear-warp composite (lit), with its host glue.

Counterpart of `tbraymarcherplugin_tpu/ops/shearwarp_pallas.py::
shearwarp_intermediate_fused` in lit mode. The glue pre-shears the volume
and light planes with batched banded matmuls (`shearwarp._resample_block`,
as the JAX package leaves them outside its kernel), computes the
per-pixel step and clip fields, the per-plane coefficients and the exact
per-chunk occupancy flags; :func:`composite` then launches
`csrc/composite.cu` for CUDA tensors or runs :func:`composite_plain` for
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from .compositing import EARLY_TERMINATION_ALPHA
from .sampling import VOLUME_DENSITY
from .shearwarp import (ShearWarpPlan, _pad_to, _resample_block, _t,
                        _volume_planes, plane_dtype)
from .transfer import windowed_tf_range_occupied

KB = 16  # planes per occupancy chunk


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _plane_param_array(plan: ShearWarpPlan, Kp: int,
                       extend: bool = False) -> np.ndarray:
    """(5, Kp[+1]) float32 rows a1, b1, a2, b2, lam. Padding planes get
    out-of-range coordinates, so the in-cube mask removes them; ``extend``
    appends one affinely extrapolated plane for the jitter path's k + 1
    reads at the last plane."""
    n = Kp + (1 if extend else 0)
    rows = []
    for x, pv in ((plan.a1, -1e9), (plan.b1, 0.0), (plan.a2, -1e9),
                  (plan.b2, 0.0), (plan.lam, 0.0)):
        x = np.asarray(x, np.float32)
        if extend:
            ex = (np.float32(2.0) * x[-1:] - x[-2:-1]) if len(x) >= 2 \
                else x[-1:]
            x = np.concatenate([x, ex])
        rows.append(np.concatenate([x, np.full(n - len(x), pv, np.float32)]))
    return np.stack(rows).astype(np.float32)


def _clip_step_fields(plan: ShearWarpPlan, clip_center, clip_direction,
                      device=None):
    """(step_world (n1, n2), e0 float, e1 (n1, n2)): per-pixel step length
    and the clip-plane dot product ``e0 + lam * e1``, affine in lam."""
    f32 = torch.float32
    cc = np.asarray(clip_center, np.float32)
    cdn = np.asarray(clip_direction, np.float32)
    a1x, a2x, dx = plan.axes12[0], plan.axes12[1], plan.axis
    cam = np.asarray(plan.cam, np.float32)
    c1, c2, cd_ = float(cam[a1x]), float(cam[a2x]), float(cam[dx])
    ii = torch.arange(plan.n1, dtype=f32, device=device)
    jj = torch.arange(plan.n2, dtype=f32, device=device)
    g1 = float(plan.o1) + (ii + 0.5) * float(plan.d1)
    g2 = float(plan.o2) + (jj + 0.5) * float(plan.d2)
    dz = float(np.float32(plan.z0) - np.float32(cd_))
    r = torch.sqrt((g1[:, None] - c1) ** 2 + (g2[None, :] - c2) ** 2
                   + float(np.float32(dz) ** 2))
    step_world = VOLUME_DENSITY * r * float(plan.dlam)
    e0 = float(np.sum((cam - cc) * cdn, dtype=np.float32))
    e1 = ((g1[:, None] - c1) * float(cdn[a1x])
          + (g2[None, :] - c2) * float(cdn[a2x])
          + float(np.float32(dz) * cdn[dx]))
    return step_world.contiguous(), e0, e1.contiguous()


def composite_plain(W, L, tf_table, pa, occ, e1, step_world, jitter, win,
                    e0: float, early_termination: float, d1: int, d2: int,
                    k_real: int) -> torch.Tensor:
    """Front-to-back lit composite of the (K[+1], n1, n2) planes ``W`` and
    ``L`` -> (4, n1, n2); the kernel's arithmetic, one PyTorch operation
    per step. ``pa`` is the (5, P) host coefficient array, ``occ`` the
    per-chunk occupancy flags and ``win`` the (4,) window (center, width,
    low, high), both tensors on the planes' device."""
    dev = e1.device
    center, width, low_c, high_c = win.tolist()
    n1, n2 = e1.shape
    pa = np.asarray(pa, np.float32)
    occ = [bool(x) for x in occ.tolist()]
    gi = torch.arange(n1, dtype=torch.float32, device=dev)[:, None]
    gj = torch.arange(n2, dtype=torch.float32, device=dev)[None, :]
    rr, rg, rb, alpha = (torch.zeros((n1, n2), device=dev) for _ in range(4))
    term = torch.zeros((n1, n2), dtype=torch.bool, device=dev)
    zero = torch.zeros((n1, n2), device=dev)
    for k in range(k_real):
        if not occ[k // KB]:
            continue
        a1k, b1k, a2k, b2k, lamk = (float(x) for x in pa[:, k])
        v1 = a1k + b1k * gi
        v2 = a2k + b2k * gj
        lam_px = lamk
        value = W[k].float()
        light = L[k].float()
        if jitter is not None:
            a1n, b1n, a2n, b2n = (float(x) for x in pa[:4, k + 1])
            v1 = v1 + (a1n + b1n * gi - v1) * jitter
            v2 = v2 + (a2n + b2n * gj - v2) * jitter
            lam_px = lamk + float(pa[4, k + 1] - pa[4, k]) * jitter
            value = value + (W[k + 1].float() - value) * jitter
            light = light + (L[k + 1].float() - light) * jitter
        m = ((v1 >= -0.5) & (v1 <= d1 - 0.5) & (v2 >= -0.5) & (v2 <= d2 - 0.5)
             & ((e0 + lam_px * e1) > 0.0) & ~term)
        tf_pos = (value - center + width * 0.5) / width
        cut = (((tf_pos < 0.0) & (low_c > 0.0))
               | ((tf_pos > 1.0) & (high_c > 0.0)))
        x = tf_pos * 256.0 - 0.5
        i0f = torch.floor(x)
        frac = (x - i0f)[..., None]
        c0 = tf_table[i0f.clamp(0.0, 255.0).long()]
        c1 = tf_table[(i0f + 1.0).clamp(0.0, 255.0).long()]
        c = c0 + (c1 - c0) * frac
        ca = c[..., 3].clamp(0.0, 1.0)
        ca = 1.0 - torch.exp(step_world * torch.log(
            torch.clamp(1.0 - ca, min=1e-10)))
        a = torch.where(m & ~cut, ca, zero)
        w = (1.0 - alpha) * a
        rr = rr + w * c[..., 0] * light
        rg = rg + w * c[..., 1] * light
        rb = rb + w * c[..., 2] * light
        alpha_new = alpha + w
        crossed = (a > 0.0) & (alpha_new > early_termination)
        alpha = torch.where(crossed, torch.ones_like(alpha), alpha_new)
        term = term | crossed
    return torch.stack([rr, rg, rb, alpha])


def composite(W, L, tf_table, pa, occ, e1, step_world, jitter, win,
              e0: float, early_termination: float, d1: int, d2: int,
              k_real: int) -> torch.Tensor:
    """Lit composite -> (4, n1, n2); see :func:`composite_plain`."""
    if W.device.type == "cpu":
        return composite_plain(W, L, tf_table, pa, occ, e1, step_world,
                               jitter, win, e0, early_termination, d1, d2,
                               k_real)
    dev = W.device
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"W must be float32 or bfloat16, got {W.dtype}")
    if tuple(tf_table.shape) != (256, 4):
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    n1, n2 = e1.shape
    pa = torch.as_tensor(np.asarray(pa, np.float32), device=dev).contiguous()
    P = pa.shape[1]
    need = k_real + (1 if jitter is not None else 0)
    if W.shape[0] < need or L.shape[0] < need or P < need:
        raise ValueError("planes or coefficients shorter than K (+1 jitter)")
    if occ.numel() * KB < k_real:
        raise ValueError("occupancy flags do not cover every plane")
    if win.numel() != 4:
        raise ValueError(f"win must hold 4 values, got {win.numel()}")
    tensors = dict(W=W, L=L, tf_table=tf_table, e1=e1, step_world=step_world,
                   occ=occ, win=win)
    if jitter is not None:
        tensors["jitter"] = jitter
    for name, t in tensors.items():
        dtype = {"W": W.dtype, "L": W.dtype, "occ": torch.int32}.get(
            name, torch.float32)
        _kernels.check(t, name, dtype, dev)
    if W.shape[1:] != (n1, n2) or L.shape[1:] != (n1, n2):
        raise ValueError("W, L and the per-pixel fields differ in shape")
    out = torch.empty((4, n1, n2), dtype=torch.float32, device=dev)
    name = "tbr_composite_bf16" if W.dtype == torch.bfloat16 \
        else "tbr_composite_f32"
    _kernels.launch(
        name, W.data_ptr(), L.data_ptr(), tf_table.data_ptr(), pa.data_ptr(),
        occ.data_ptr(), e1.data_ptr(), step_world.data_ptr(),
        jitter.data_ptr() if jitter is not None else None, win.data_ptr(),
        out.data_ptr(), n1, n2, k_real, P, e0, early_termination, float(d1),
        float(d2), _kernels.stream_of(W),
    )
    composite.launches += 1
    return out


composite.launches = 0


def prepare_composite(volume, tf_table, light_volume, plan: ShearWarpPlan,
                      windowing_vec4, clip_center, clip_direction,
                      early_termination: float = EARLY_TERMINATION_ALPHA,
                      compute_dtype=None, jitter=None) -> dict:
    """The keyword arguments of :func:`composite` for one frame.

    ``compute_dtype`` is the storage type of the pre-sheared planes (None:
    `shearwarp.plane_dtype`'s, bfloat16 on the card and float32 on the
    CPU). ``jitter``: optional (n1, n2) per-pixel lam phase in [0, 1).
    """
    dev = volume.device
    compute_dtype = plane_dtype(compute_dtype, dev)
    n1, n2, K = plan.n1, plan.n2, plan.k
    Kp = _ceil_to(K, KB)
    nch = Kp // KB
    jitter_on = jitter is not None
    Kbuf = Kp + 1 if jitter_on else Kp

    ax = (plan.axis,) + tuple(plan.axes12)

    # The streams are edge-padded to Kbuf planes (the jittered last plane
    # lerps toward a copy of itself; other padding is masked). Repeating the
    # last plane's slice and coefficients before the resample gives those
    # copies without a second pass over the streams.
    def coeff(name):
        return _pad_to(_t(getattr(plan, name), dev), Kbuf)

    vplanes = _volume_planes(volume.permute(ax), plan)
    W = _resample_block(_pad_to(vplanes, Kbuf), coeff("a1"), coeff("b1"),
                        coeff("a2"), coeff("b2"), n1, n2, compute_dtype)
    light_t = light_volume.permute(ax)
    lm0 = _t(plan.lm0, dev)
    l0 = light_t[lm0]
    l1 = light_t[(lm0 + 1).clamp(max=light_t.shape[0] - 1)]
    lmt = _t(plan.lmt, dev)[:, None, None]
    lplanes = l0 * (1.0 - lmt) + l1 * lmt
    L = _resample_block(_pad_to(lplanes, Kbuf), coeff("la1"), coeff("lb1"),
                        coeff("la2"), coeff("lb2"), n1, n2, compute_dtype)

    # Chunk occupancy: can any value in a chunk's range give alpha > 0?
    # (plan data: computed on detached values, it takes no gradient)
    inf = torch.tensor([float("inf")], device=dev)
    vp = vplanes.detach()
    sl_mn = torch.cat([vp.amin((1, 2)), inf.expand(Kp - K)])
    sl_mx = torch.cat([vp.amax((1, 2)), -inf.expand(Kp - K)])
    mn_c = sl_mn.view(nch, KB).amin(1)
    mx_c = sl_mx.view(nch, KB).amax(1)
    if jitter_on:  # jittered samples of chunk c lerp into plane (c + 1) * KB
        nxt = ((torch.arange(nch, device=dev) + 1) * KB).clamp(max=Kp - 1)
        mn_c = torch.minimum(mn_c, sl_mn[nxt])
        mx_c = torch.maximum(mx_c, sl_mx[nxt])
    win = torch.as_tensor(windowing_vec4, dtype=torch.float32, device=dev)
    occ = windowed_tf_range_occupied(mn_c, mx_c, win.detach(),
                                     tf_table.detach())

    step_world, e0, e1 = _clip_step_fields(plan, clip_center, clip_direction,
                                           dev)
    D1 = volume.shape[plan.axes12[0]]
    D2 = volume.shape[plan.axes12[1]]
    return dict(
        W=W, L=L, tf_table=tf_table.contiguous(),
        pa=_plane_param_array(plan, Kp, extend=jitter_on),
        occ=occ.to(torch.int32).contiguous(), e1=e1, step_world=step_world,
        jitter=None if jitter is None else jitter.contiguous(),
        win=win.contiguous(), e0=e0,
        early_termination=float(early_termination), d1=D1, d2=D2, k_real=K,
    )


def shearwarp_intermediate_fused(volume, tf_table, light_volume,
                                 plan: ShearWarpPlan, windowing_vec4,
                                 clip_center, clip_direction,
                                 early_termination: float = EARLY_TERMINATION_ALPHA,
                                 compute_dtype=None,
                                 jitter=None) -> torch.Tensor:
    """Lit shear-warp composite -> (4, n1, n2), the layout
    `warp.warp_to_screen_fused` reads."""
    ops = prepare_composite(volume, tf_table, light_volume, plan,
                            windowing_vec4, clip_center, clip_direction,
                            early_termination, compute_dtype, jitter)
    return composite(**ops)
