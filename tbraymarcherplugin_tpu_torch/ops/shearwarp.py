"""Shear-warp factorization: host plan, pre-shear, the dense composite, the
plain screen warp and the scene-depth λ ceiling.

Counterpart of `tbraymarcherplugin_tpu/ops/shearwarp.py`. The perspective
view factors into (1) a separable per-plane 2D resample of the volume onto
an intermediate ray grid, two banded matrices per plane applied as batched
matmuls, (2) a front-to-back composite over planes
(:func:`shearwarp_intermediate` here, dense and differentiable through
autograd, or the fused kernels of `composite.py` and `shearwarp_grad.py`)
and (3) a two-pass 1D warp of the intermediate image to the screen
(`warp.py`; :func:`warp_to_screen` here is its plain form).

:func:`plan_shearwarp` is host numpy and gives the same float32 numbers as
the JAX package's plan for the same camera.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.device import to_device
from .compositing import EARLY_TERMINATION_ALPHA
from .sampling import sample_windowed_transfer_function
from .tf_rgba import windowed_tf_rgba_vjp
from .transfer import windowed_tf_range_occupied


@dataclasses.dataclass(frozen=True)
class ShearWarpPlan:
    """Factorization geometry of one (camera, volume) pair.

    Per-plane arrays are ordered front to back; scalars are float32.
    ``msrc_hi``/``mfrac`` are None when planes sit on voxel centers.
    ``j0`` > 0 makes the plan a column slab of a wider grid: its columns
    are the grid's j0 .. j0 + n2 - 1, and every column coordinate
    (``a2 + b2 * j``, ``la2 + lb2 * j``, ``o2 + (j + 0.5) * d2``) is
    evaluated at the grid's own index j, so a slab's samples are the full
    grid's bit for bit (`parallel/shearwarp_sharding.py`).
    """

    axis: int
    axes12: tuple
    n1: int
    n2: int
    k: int
    swap_warp: bool
    m_src: np.ndarray  # (K,) int32 volume slice per plane
    lam: np.ndarray  # (K,) λ per plane
    msrc_hi: np.ndarray | None
    mfrac: np.ndarray | None
    a1: np.ndarray  # sample voxel coord along axes12[0]: v1 = a1 + b1 * i
    b1: np.ndarray
    a2: np.ndarray
    b2: np.ndarray
    la1: np.ndarray  # light-volume voxel coords, same form
    lb1: np.ndarray
    la2: np.ndarray
    lb2: np.ndarray
    lm0: np.ndarray  # (K,) int32 light slice lower index
    lmt: np.ndarray  # (K,) light dominant-axis lerp weight
    cam: np.ndarray  # (3,) camera position in UVW
    z0: np.float32  # reference plane depth along `axis`
    o1: np.float32  # intermediate grid origin/spacing on the z0 plane
    d1: np.float32
    o2: np.float32
    d2: np.float32
    dlam: np.float32  # λ spacing between consecutive planes
    p1row: np.ndarray  # (3,) homography rows: x = (Pr @ (u, v, 1)) / (Pd @ ...)
    p2row: np.ndarray
    pdrow: np.ndarray
    j0: int = 0  # the first column of a column slab (see above)

    def memo(self, key, make):
        """``make()``, made once for ``key`` and kept with this plan: what a
        frame derives from the plan alone, such as the pre-shear's device
        arrays (`preshear.plan_streams`). Not a field: a replaced plan
        (`dataclasses.replace`) keeps nothing of it."""
        kept = self.__dict__.setdefault("_memo", {})
        if key not in kept:
            kept[key] = make()
        return kept[key]


def rebased_columns(plan: ShearWarpPlan):
    """(a2, la2, o2) re-based to the slab's local column 0, float32 as the
    JAX package's `parallel.shearwarp_sharding._local_plan` rounds them:
    the form a kernel that counts local columns reads (K1's and K5's
    in-cube test, an ulp from the full grid's at the cube's faces)."""
    off = np.float32(plan.j0)
    return (plan.a2 + plan.b2 * off, plan.la2 + plan.lb2 * off,
            plan.o2 + off * plan.d2)


def columns(plan: ShearWarpPlan, device=None) -> torch.Tensor:
    """(n2,) float32 indices of the plan's columns in its grid."""
    return torch.arange(plan.j0, plan.j0 + plan.n2, dtype=torch.float32,
                        device=device)


def _camera_affine_dirs(camera, width: int, height: int) -> np.ndarray:
    """A (3, 3) with unnormalized world ray direction D(u, v) = A @ (u, v, 1)
    at pixel centers (u = column, v = row)."""
    aspect = height / width
    rot = np.asarray(camera.rotation, np.float64)
    right, up, forward = rot[0], rot[1], rot[2]
    t = float(camera.tan_half_fov)
    du = 2.0 * t / width
    dv = -2.0 * t * aspect / height
    px0 = (0.5 / width * 2.0 - 1.0) * t
    py0 = (1.0 - 0.5 / height * 2.0) * t * aspect
    A = np.zeros((3, 3))
    A[:, 0] = du * right
    A[:, 1] = dv * up
    A[:, 2] = px0 * right + py0 * up + forward
    return A


def plan_shearwarp(camera, transform, vol_dims, light_dims, width: int,
                   height: int, oversample: float = 1.0, max_n: int = 2048,
                   align: int = 128, max_planes: int | None = None):
    """Build a :class:`ShearWarpPlan`, or None when the camera is inside the
    dominant slab (or the view is degenerate)."""
    vol_dims = tuple(int(d) for d in vol_dims)
    light_dims = tuple(int(d) for d in light_dims)
    rot = np.asarray(transform.rotation, np.float64)
    trans = np.asarray(transform.translation, np.float64)
    scale = np.asarray(transform.scale, np.float64)
    cam_local = (np.asarray(camera.position, np.float64) - trans) @ rot.T / scale
    c = cam_local + 0.5  # UVW

    view = np.array([0.5, 0.5, 0.5]) - c
    if np.linalg.norm(view) < 1e-9:
        return None
    d_axis = int(np.argmax(np.abs(view)))
    a1_axis, a2_axis = [a for a in range(3) if a != d_axis]
    D = vol_dims[d_axis]

    # Plane depths front to back: on voxel centers, or ``max_planes``
    # uniformly spaced planes that lerp two slices.
    if max_planes is None or max_planes >= D:
        idx = np.arange(D, dtype=np.float64)
    else:
        idx = np.linspace(0.0, D - 1.0, max(int(max_planes), 2))
    if c[d_axis] > 0.5:
        idx = idx[::-1]
    wp = (idx + 0.5) / D
    m0 = np.clip(np.floor(idx), 0, D - 1).astype(np.int32)
    mfr = idx - m0
    exact = bool(np.all(mfr == 0.0))
    K = len(idx)
    z0 = wp[0]
    denom = z0 - c[d_axis]
    if abs(denom) < 1e-6 or (0.0 < c[d_axis] < 1.0):
        return None  # camera inside the slab (or on the reference plane)
    lam = (wp - c[d_axis]) / denom
    dlam = float(lam[1] - lam[0]) if K > 1 else 1.0 / D / abs(denom)

    def preimage(c_a):
        lo = c_a + (0.0 - c_a) / lam
        hi = c_a + (1.0 - c_a) / lam
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        return float(lo.min()), float(hi.max())

    g1lo, g1hi = preimage(c[a1_axis])
    g2lo, g2hi = preimage(c[a2_axis])
    eps = 1e-4
    g1lo, g1hi = g1lo - eps, g1hi + eps
    g2lo, g2hi = g2lo - eps, g2hi + eps

    # Screen -> plane homography (resolution choice and the final warp).
    A = _camera_affine_dirs(camera, width, height)
    Al = (A.T @ rot.T).T / scale[:, None]
    kappa = z0 - c[d_axis]
    p1row = c[a1_axis] * Al[d_axis] + kappa * Al[a1_axis]
    p2row = c[a2_axis] * Al[d_axis] + kappa * Al[a2_axis]
    pdrow = Al[d_axis].copy()

    # Grid spacing: median screen-projected footprint per pixel, sampled on
    # a coarse grid over pixels that hit the footprint.
    us = np.linspace(0, width - 1, 65)
    vs = np.linspace(0, height - 1, 65)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    den = pdrow[0] * uu + pdrow[1] * vv + pdrow[2]
    ok = np.abs(den) > 1e-9
    den = np.where(ok, den, 1.0)
    p1 = (p1row[0] * uu + p1row[1] * vv + p1row[2]) / den
    p2 = (p2row[0] * uu + p2row[1] * vv + p2row[2]) / den
    tplane = kappa / den
    hit = (ok & (tplane > 0) & (p1 >= g1lo) & (p1 <= g1hi)
           & (p2 >= g2lo) & (p2 <= g2hi))
    sx = (us[1] - us[0]) if len(us) > 1 else 1.0
    sy = (vs[1] - vs[0]) if len(vs) > 1 else 1.0

    def spacing(p):
        gu = np.abs(np.gradient(p, axis=1)) / sx
        gv = np.abs(np.gradient(p, axis=0)) / sy
        g = np.maximum(gu, gv)[hit]
        g = g[g > 1e-12]
        if g.size == 0:
            return None
        return float(np.median(g))

    s1 = spacing(p1)
    s2 = spacing(p2)

    def choose_n(extent, sp, dim):
        n = dim if sp is None else int(math.ceil(extent / sp * oversample))
        n = min(max(n, 16), max_n)
        return -(-n // align) * align

    n1 = choose_n(g1hi - g1lo, s1, vol_dims[a1_axis])
    n2 = choose_n(g2hi - g2lo, s2, vol_dims[a2_axis])
    # Total-sample budget near the screen's own pixel count.
    max_pixels = max(int(0.8 * width * height), 256 * 256)
    if n1 * n2 > max_pixels:
        shrink = math.sqrt(max_pixels / (n1 * n2))
        n1 = max(align, int(n1 * shrink) // align * align)
        n2 = max(align, int(n2 * shrink) // align * align)
    if align >= 128:
        # Quantize grid sizes (quantum lcm(256, align)) so a zooming camera
        # revisits the same shapes.
        quantum = 256 * align // math.gcd(256, align)
        cap = max(align, max_n // align * align)
        n1 = max(align, min(-(-n1 // quantum) * quantum, cap))
        n2 = max(align, min(-(-n2 // quantum) * quantum, cap))
    d1 = (g1hi - g1lo) / n1
    d2 = (g2hi - g2lo) / n2

    def coeffs(c_a, glo, dg, dim):
        a = (c_a * (1.0 - lam) + lam * (glo + 0.5 * dg)) * dim - 0.5
        b = lam * dg * dim
        return a, b

    D1, D2 = vol_dims[a1_axis], vol_dims[a2_axis]
    a1, b1 = coeffs(c[a1_axis], g1lo, d1, D1)
    a2, b2 = coeffs(c[a2_axis], g2lo, d2, D2)
    L1, L2 = light_dims[a1_axis], light_dims[a2_axis]
    la1, lb1 = coeffs(c[a1_axis], g1lo, d1, L1)
    la2, lb2 = coeffs(c[a2_axis], g2lo, d2, L2)
    LD = light_dims[d_axis]
    lv = wp * LD - 0.5
    lm0 = np.clip(np.floor(lv), 0, LD - 1).astype(np.int32)
    lmt = np.clip(lv - lm0, 0.0, 1.0)

    # Warp pass pairing: swap screen u/v roles when the homography maps i
    # mostly along screen v.
    cu, cv = width / 2.0, height / 2.0
    den_c = pdrow[0] * cu + pdrow[1] * cv + pdrow[2]
    if abs(den_c) > 1e-9:
        J = np.zeros((2, 2))
        for r, prow in enumerate((p1row, p2row)):
            num_c = prow[0] * cu + prow[1] * cv + prow[2]
            J[r, 0] = (prow[0] * den_c - num_c * pdrow[0]) / den_c**2
            J[r, 1] = (prow[1] * den_c - num_c * pdrow[1]) / den_c**2
        swap_warp = bool(abs(J[0, 0] * J[1, 1]) < abs(J[0, 1] * J[1, 0]))
    else:
        swap_warp = False

    def f32(x):
        return np.asarray(x, np.float32)

    return ShearWarpPlan(
        axis=d_axis, axes12=(a1_axis, a2_axis), n1=int(n1), n2=int(n2),
        k=int(K), swap_warp=swap_warp,
        m_src=m0,
        msrc_hi=None if exact else np.minimum(m0 + 1, D - 1).astype(np.int32),
        mfrac=None if exact else f32(mfr),
        lam=f32(lam), a1=f32(a1), b1=f32(b1), a2=f32(a2), b2=f32(b2),
        la1=f32(la1), lb1=f32(lb1), la2=f32(la2), lb2=f32(lb2),
        lm0=lm0, lmt=f32(lmt), cam=f32(c), z0=np.float32(z0),
        o1=np.float32(g1lo), d1=np.float32(d1), o2=np.float32(g2lo),
        d2=np.float32(d2), dlam=np.float32(abs(dlam)),
        p1row=f32(p1row), p2row=f32(p2row), pdrow=f32(pdrow),
    )


def _t(x, device, dtype=None):
    """Plan array -> tensor on ``device`` (int arrays -> int64 indices)."""
    x = np.asarray(x)
    if x.dtype.kind == "i":
        return to_device(x.astype(np.int64), device)
    return to_device(x.astype(np.float32), device, dtype)


def _volume_planes(vol_t: torch.Tensor, plan: ShearWarpPlan,
                   nearest: bool = False) -> torch.Tensor:
    """Front-to-back (K, D1, D2) sample planes of the axis-permuted volume:
    slice takes, or a two-slice lerp for fractional plane positions;
    ``nearest`` takes the closer slice instead (the octree mode's
    `Texture3D.Load`)."""
    dev = vol_t.device
    if plan.mfrac is None:
        return vol_t[_t(plan.m_src, dev)]
    if nearest:
        return vol_t[_t(np.where(plan.mfrac < 0.5, plan.m_src, plan.msrc_hi),
                        dev)]
    v0 = vol_t[_t(plan.m_src, dev)]
    v1 = vol_t[_t(plan.msrc_hi, dev)]
    t = _t(plan.mfrac, dev)[:, None, None]
    return v0 * (1.0 - t) + v1 * t


def _resample_matrices(a, b, dim: int, n: int, dtype,
                       nearest: bool = False, i0: int = 0,
                       rows=None) -> torch.Tensor:
    """Banded linear-interpolation matrices S (B, dim, n):
    S[p, m, i] = hat(clip(a[p] + b[p] * (i0 + i), 0, dim - 1) - m); with
    ``nearest`` a one-hot selection of floor(clip(...) + 0.5) (the octree
    mode's nearest texel). ``rows`` = (m0, m1): only the rows m0 .. m1 - 1
    (a slab's share of the taps), (B, m1 - m0, n)."""
    i = torch.arange(i0, i0 + n, dtype=torch.float32, device=a.device)
    v = a[:, None] + b[:, None] * i[None, :]
    vc = v.clamp(0.0, float(dim - 1))
    m = torch.arange(*(rows or (dim,)), dtype=torch.float32,
                     device=a.device)
    if nearest:
        sel = torch.floor(vc + 0.5)
        return (sel[:, None, :] == m[None, :, None]).to(dtype)
    S = (1.0 - (vc[:, None, :] - m[None, :, None]).abs()).clamp(min=0.0)
    return S.to(dtype)


def plane_dtype(compute_dtype, device) -> torch.dtype:
    """The storage type of pre-sheared plane operands: ``compute_dtype``,
    or for None bfloat16 on the card (the JAX accelerator path's default)
    and float32 on the CPU; one meaning for every shear-warp composite."""
    if compute_dtype is not None:
        return compute_dtype
    return torch.float32 if torch.device(device).type == "cpu" else (
        torch.bfloat16)


def _resample_block(slices, a1, b1, a2, b2, n1: int, n2: int,
                    dtype=torch.float32, f32_out: bool = False,
                    nearest: bool = False, j0: int = 0) -> torch.Tensor:
    """(B, D1, D2) slices -> (B, n1, n2) sheared samples by two batched
    banded matmuls (exactly separable bilinear, or with ``nearest`` a
    one-hot selection of the nearest texel), stored as ``dtype``; the
    columns are j0 .. j0 + n2 - 1 (a column slab, `ShearWarpPlan.j0`).

    ``f32_out``: the operands are rounded to ``dtype`` but the products are
    float32, as the JAX package's ``preferred_element_type=float32`` einsums
    (the dense composite's samples); the fused path stores ``dtype``."""
    S1 = _resample_matrices(a1, b1, slices.shape[1], n1, dtype, nearest)
    S2 = _resample_matrices(a2, b2, slices.shape[2], n2, dtype, nearest,
                            j0)
    if not f32_out:
        t = torch.bmm(S1.transpose(1, 2), slices.to(dtype))
        return torch.bmm(t, S2)
    f32 = torch.float32
    t = torch.bmm(S1.transpose(1, 2).to(f32), slices.to(dtype).to(f32))
    return torch.bmm(t.to(dtype).to(f32), S2.to(f32))


def _plane_value_ranges(sl_mn, sl_mx, plan: ShearWarpPlan):
    """Conservative per-plane (min, max) from per-slice stats: a plane's
    values are convex combinations of (at most two) slices' texels."""
    dev = sl_mn.device
    pmn, pmx = sl_mn[_t(plan.m_src, dev)], sl_mx[_t(plan.m_src, dev)]
    if plan.mfrac is not None:
        hi = _t(plan.msrc_hi, dev)
        pmn = torch.minimum(pmn, sl_mn[hi])
        pmx = torch.maximum(pmx, sl_mx[hi])
    return pmn, pmx


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last entry repeated along axis 0 up to ``n`` rows."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])])


def shearwarp_intermediate(volume, tf_table, light_volume, plan: ShearWarpPlan,
                           windowing_vec4, clip_center, clip_direction,
                           block_size: int = 8,
                           early_termination: float = EARLY_TERMINATION_ALPHA,
                           stop_early: bool = False,
                           compute_dtype=torch.float32,
                           tf_unit: str = "xla") -> torch.Tensor:
    """The dense front-to-back composite onto the intermediate ray grid ->
    (n1, n2, 4) RGBA, in blocks of ``block_size`` planes.

    Each block pre-shears its volume and light planes (float32 products of
    ``compute_dtype`` operands, as the JAX package's einsums with
    ``preferred_element_type=float32``; None: see :func:`plane_dtype`),
    windows them through the TF (``tf_unit``
    ``"xla"``: `sampling.sample_windowed_transfer_function`; ``"pallas"``:
    `tf_rgba.windowed_tf_rgba_vjp`, kernels K10a/K10b), masks samples
    outside the cube, behind the clip plane or on padding planes, and
    composites with a cumulative product of (1 - alpha) and exact
    first-crossing early termination.

    ``stop_early=False`` is differentiable to the volume, the TF, the window
    and the light volume; each block runs under a non-reentrant
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so
    the backward recomputes one block at a time. ``stop_early=True`` is
    forward only: it skips a block whose planes' value range gives no alpha
    and leaves once every ray has terminated.

    The JAX package slices the per-plane ``lam`` of the last block without
    padding it (``dynamic_slice`` clamps its start), which shifts the clip
    test of that block's planes when ``block_size`` does not divide the
    plane count; here ``lam`` is padded like every other per-plane array.
    """
    from .composite import _clip_step_fields  # composite imports this module

    if tf_unit not in ("xla", "pallas"):
        raise ValueError(f"unknown tf_unit {tf_unit!r}; choose 'xla' or "
                         f"'pallas'")
    dev = volume.device
    compute_dtype = plane_dtype(compute_dtype, dev)
    n1, n2, K = plan.n1, plan.n2, plan.k
    B = block_size
    nblk = -(-K // B)
    Kp = nblk * B
    win = torch.as_tensor(windowing_vec4, dtype=torch.float32, device=dev)

    ax = (plan.axis,) + tuple(plan.axes12)
    vol_t = volume.permute(ax)
    light_t = light_volume.permute(ax)
    vplanes_all = _pad_to(_volume_planes(vol_t, plan), Kp)
    coeff = [_pad_to(_t(getattr(plan, name), dev), Kp) for name in (
        "a1", "b1", "a2", "b2", "la1", "lb1", "la2", "lb2", "lmt", "lam")]
    lm0 = _pad_to(_t(plan.lm0, dev), Kp)
    lm0_hi = (lm0 + 1).clamp(max=light_t.shape[0] - 1)
    plane_valid = torch.arange(Kp, device=dev) < K
    ii = torch.arange(n1, dtype=torch.float32, device=dev)
    jj = columns(plan, dev)
    step_world, e0, e1 = _clip_step_fields(plan, clip_center, clip_direction,
                                           dev)
    D1 = volume.shape[plan.axes12[0]]
    D2 = volume.shape[plan.axes12[1]]
    step_ids = torch.arange(B, device=dev).reshape(B, 1, 1)

    def block_values(b):
        """Sheared volume and light samples (B, n1, n2) and their mask."""
        sl = slice(b * B, (b + 1) * B)
        a1b, b1b, a2b, b2b, la1b, lb1b, la2b, lb2b, lmtb, lamb = (
            x[sl] for x in coeff)
        vals = _resample_block(vplanes_all[sl], a1b, b1b, a2b, b2b, n1, n2,
                               compute_dtype, f32_out=True, j0=plan.j0)
        t = lmtb[:, None, None]
        lblk = light_t[lm0[sl]] * (1.0 - t) + light_t[lm0_hi[sl]] * t
        light = _resample_block(lblk, la1b, lb1b, la2b, lb2b, n1, n2,
                                compute_dtype, f32_out=True, j0=plan.j0)
        v1 = a1b[:, None] + b1b[:, None] * ii[None, :]  # (B, n1)
        v2 = a2b[:, None] + b2b[:, None] * jj[None, :]  # (B, n2)
        in1 = (v1 >= -0.5) & (v1 <= D1 - 0.5)
        in2 = (v2 >= -0.5) & (v2 <= D2 - 0.5)
        clipped = (e0 + lamb[:, None, None] * e1[None]) <= 0.0
        m = (in1[:, :, None] & in2[:, None, :] & ~clipped
             & plane_valid[sl][:, None, None])
        return vals, light, m

    def block_composite(rgb_acc, alpha_acc, terminated, b):
        vals, light, m = block_values(b)
        if tf_unit == "pallas":
            rgba = windowed_tf_rgba_vjp(vals, tf_table, win, step_world)
        else:
            rgba = sample_windowed_transfer_function(vals, step_world[None],
                                                     tf_table, win)
        zero = rgba.new_zeros(())
        a = torch.where(m, rgba[..., 3], zero)
        rgb = torch.where(m[..., None], rgba[..., :3] * light[..., None],
                          zero)
        t_incl = torch.cumprod(1.0 - a, dim=0)
        t_excl = torch.cat([torch.ones_like(t_incl[:1]), t_incl[:-1]], 0)
        alpha_after = alpha_acc[None] + (1.0 - alpha_acc[None]) * (1.0 - t_incl)
        crossed = m & (alpha_after > early_termination)
        any_crossed = crossed.any(0)
        kc = crossed.to(torch.uint8).argmax(0)  # the first crossing plane
        contrib = torch.where(any_crossed[None], step_ids <= kc[None],
                              torch.ones_like(crossed))
        contrib = contrib & ~terminated[None]
        w = torch.where(contrib, t_excl * a, zero)
        rgb_out = rgb_acc + (1.0 - alpha_acc)[..., None] * (
            w[..., None] * rgb).sum(0)
        alpha_noterm = alpha_acc + (1.0 - alpha_acc) * (1.0 - t_incl[-1])
        newly = any_crossed & ~terminated
        alpha_out = torch.where(
            newly, torch.ones_like(alpha_acc),
            torch.where(terminated, alpha_acc, alpha_noterm))
        return rgb_out, alpha_out, terminated | any_crossed

    carry = (torch.zeros((n1, n2, 3), device=dev),
             torch.zeros((n1, n2), device=dev),
             torch.zeros((n1, n2), dtype=torch.bool, device=dev))
    if stop_early:
        with torch.no_grad():
            pmn, pmx = _plane_value_ranges(vol_t.amin((1, 2)),
                                           vol_t.amax((1, 2)), plan)
            blk_occ = windowed_tf_range_occupied(
                _pad_to(pmn, Kp).view(nblk, B).amin(1),
                _pad_to(pmx, Kp).view(nblk, B).amax(1), win, tf_table)
            for b, occupied in enumerate(blk_occ.tolist()):
                if bool(carry[2].all()):
                    break
                if occupied:
                    carry = block_composite(*carry, b)
    else:
        grad = torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (volume, tf_table, light_volume, win))
        for b in range(nblk):
            if grad:
                carry = checkpoint(block_composite, *carry, b,
                                   use_reentrant=False)
            else:
                carry = block_composite(*carry, b)
    rgb, alpha, _ = carry
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _lerp_take(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row 1D linear interpolation ``out[r, q] = lerp(rows[r], idx[r, q])``
    with clamp-to-edge."""
    n = rows.shape[-1]
    ic = idx.clamp(0.0, float(n - 1))
    i0 = torch.floor(ic)
    fr = ic - i0
    i0 = i0.long()
    i1 = (i0 + 1).clamp(max=n - 1)
    r0 = torch.gather(rows, -1, i0)
    r1 = torch.gather(rows, -1, i1)
    return r0 + (r1 - r0) * fr


def warp_rows(plan: ShearWarpPlan, width: int, height: int):
    """Screen-pass geometry: (p1row, p2row, pdrow, W, H) with screen u/v
    swapped when ``plan.swap_warp``."""
    p1r, p2r, pdr = (np.asarray(r, np.float32) for r in
                     (plan.p1row, plan.p2row, plan.pdrow))
    if plan.swap_warp:
        perm = [1, 0, 2]
        return p1r[perm], p2r[perm], pdr[perm], height, width
    return p1r, p2r, pdr, width, height


def screen_fields(plan: ShearWarpPlan, W: int, H: int, p1r, p2r, pdr,
                  device=None):
    """Pass-2 index field j(u, v) and the validity mask, both (W, H)."""
    f32 = torch.float32
    u = torch.arange(W, dtype=f32, device=device)[:, None]
    v = torch.arange(H, dtype=f32, device=device)[None, :]
    p1r, p2r, pdr = (r.tolist() for r in (p1r, p2r, pdr))
    den = pdr[0] * u + pdr[1] * v + pdr[2]
    ok = den.abs() > 1e-9
    den = torch.where(ok, den, torch.ones_like(den))
    p1uv = (p1r[0] * u + p1r[1] * v + p1r[2]) / den
    p2uv = (p2r[0] * u + p2r[1] * v + p2r[2]) / den
    kappa = float(np.float32(plan.z0) - np.float32(plan.cam[plan.axis]))
    tplane = kappa / den
    j_uv = (p2uv - float(plan.o2)) / float(plan.d2) - 0.5
    i_uv = (p1uv - float(plan.o1)) / float(plan.d1) - 0.5
    valid = (ok & (tplane > 0.0) & (i_uv > -1.0) & (i_uv < plan.n1)
             & (j_uv > -1.0) & (j_uv < plan.n2))
    return j_uv, valid


def warp_to_screen(intermediate: torch.Tensor, plan: ShearWarpPlan,
                   width: int, height: int) -> torch.Tensor:
    """Plain two-pass (Catmull-Smith) warp of the (n1, n2, C) intermediate
    image to the (height, width, C) screen; pixels whose ray misses the
    grid get 0."""
    dev = intermediate.device
    f32 = torch.float32
    p1r, p2r, pdr, W, H = warp_rows(plan, width, height)
    o1, d1, o2, d2 = (float(x) for x in (plan.o1, plan.d1, plan.o2, plan.d2))
    u = torch.arange(W, dtype=f32, device=dev)
    pr1, pr2, prd = p1r.tolist(), p2r.tolist(), pdr.tolist()

    # pass 1: i*(u, j) through the inverted j-homography v*(u, j)
    jj = torch.arange(plan.n2, dtype=f32, device=dev)
    p2_of_j = o2 + (jj + 0.5) * d2
    n2u = pr2[0] * u[:, None] + pr2[2]
    dnu = prd[0] * u[:, None] + prd[2]
    denv = pr2[1] - p2_of_j[None, :] * prd[1]
    denv = torch.where(denv.abs() < 1e-12, torch.full_like(denv, 1e-12), denv)
    v_star = (p2_of_j[None, :] * dnu - n2u) / denv
    den_s = prd[0] * u[:, None] + prd[1] * v_star + prd[2]
    den_s = torch.where(den_s.abs() < 1e-12, torch.full_like(den_s, 1e-12),
                        den_s)
    p1_s = (pr1[0] * u[:, None] + pr1[1] * v_star + pr1[2]) / den_s
    i_star = (p1_s - o1) / d1 - 0.5  # (W, n2)

    C = intermediate.shape[-1]
    I_t = intermediate.permute(2, 1, 0)  # (C, n2, n1)
    idx1 = i_star.T.contiguous()  # (n2, W)
    M = _lerp_take(I_t, idx1[None].expand(C, -1, -1).contiguous())

    # pass 2: lerp along j per screen column
    j_uv, valid = screen_fields(plan, W, H, p1r, p2r, pdr, dev)
    M_t = M.permute(0, 2, 1)  # (C, W, n2)
    S = _lerp_take(M_t.contiguous(),
                   j_uv[None].expand(C, -1, -1).contiguous())
    S = torch.where(valid[None], S, torch.zeros_like(S))
    img = S.permute(2, 1, 0)  # (H, W, C)
    if plan.swap_warp:
        img = img.permute(1, 0, 2)
    return img.contiguous()


def shearwarp_lit(volume, tf_table, light_volume, plan: ShearWarpPlan,
                  windowing_vec4, clip_center, clip_direction, width: int,
                  height: int, block_size: int = 8,
                  early_termination: float = EARLY_TERMINATION_ALPHA,
                  stop_early: bool = False,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """The dense shear-warp lit render to a (height, width, 4) screen
    image: :func:`shearwarp_intermediate`, then :func:`warp_to_screen`."""
    inter = shearwarp_intermediate(
        volume, tf_table, light_volume, plan, windowing_vec4, clip_center,
        clip_direction, block_size=block_size,
        early_termination=early_termination, stop_early=stop_early,
        compute_dtype=compute_dtype)
    return warp_to_screen(inter, plan, width, height)


def depth_to_lambda_max(plan: ShearWarpPlan, scene_depth, width: int,
                        height: int, device=None) -> torch.Tensor:
    """(n1, n2) per-intermediate-pixel λ ceiling from a (height, width)
    scene-depth map (distances along the normalized local ray, the units of
    `rays.setup_rays`'s ``scene_depth``; `rays.scene_depth_from_plane`
    makes one). The sample of plane k sits at camera distance r·λ_k, so the
    composite masks samples with λ > depth / r: the shear-warp form of the
    reference's depth-buffer clamp (`RaymarchMaterialCommon.usf:26-44`).

    Each grid point maps to the screen by the closed-form inverse
    homography (the 2x2 system (p_row - g·pd_row)·(u, v, 1) = 0), where the
    depth map is sampled bilinearly; +inf where that depth is not finite.
    ``device``: the output's (default: the depth map's, if a tensor)."""
    if device is None and isinstance(scene_depth, torch.Tensor):
        device = scene_depth.device
    f32 = torch.float32
    depth = torch.as_tensor(scene_depth, dtype=f32, device=device)
    ii = torch.arange(plan.n1, dtype=f32, device=device)
    jj = columns(plan, device)
    g1 = float(plan.o1) + (ii + 0.5) * float(plan.d1)  # (n1,)
    g2 = float(plan.o2) + (jj + 0.5) * float(plan.d2)  # (n2,)
    p1r, p2r, pdr = (np.asarray(r, np.float32).tolist() for r in
                     (plan.p1row, plan.p2row, plan.pdrow))
    a11 = (p1r[0] - g1 * pdr[0])[:, None]
    a12 = (p1r[1] - g1 * pdr[1])[:, None]
    b1 = -(p1r[2] - g1 * pdr[2])[:, None]
    a21 = (p2r[0] - g2 * pdr[0])[None, :]
    a22 = (p2r[1] - g2 * pdr[1])[None, :]
    b2 = -(p2r[2] - g2 * pdr[2])[None, :]
    det = a11 * a22 - a12 * a21
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    u = (b1 * a22 - a12 * b2) / det  # (n1, n2) screen column
    v = (a11 * b2 - b1 * a21) / det  # (n1, n2) screen row

    uc = u.clamp(0.0, width - 1.0)
    vc = v.clamp(0.0, height - 1.0)
    u0 = torch.floor(uc)
    v0 = torch.floor(vc)
    fu = uc - u0
    fv = vc - v0
    u0, v0 = u0.long(), v0.long()
    u1 = (u0 + 1).clamp(max=width - 1)
    v1 = (v0 + 1).clamp(max=height - 1)
    flat = depth.reshape(-1)

    def at(vi, ui):
        return flat[vi * width + ui]

    d = (at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u1) * fu * (1 - fv)
         + at(v1, u0) * (1 - fu) * fv + at(v1, u1) * fu * fv)

    cam = np.asarray(plan.cam, np.float32)
    c1, c2, cd = (float(cam[a]) for a in (*plan.axes12, plan.axis))
    dz = float(np.float32(plan.z0) - np.float32(cd))
    r = torch.sqrt((g1[:, None] - c1) ** 2 + (g2[None, :] - c2) ** 2
                   + float(np.float32(dz) ** 2))
    return torch.where(torch.isfinite(d), d / r, torch.full_like(d, math.inf))
