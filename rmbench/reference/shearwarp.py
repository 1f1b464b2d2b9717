"""The reference's shear-warp frame: the host plan, the pre-shear, the
composite and the two-pass screen warp, in plain PyTorch and numpy.

Frozen copies of `tbraymarcherplugin_tpu_torch/ops/shearwarp.py`
(`plan_shearwarp`, the plane resample, `warp_to_screen`) and
`ops/composite.py` (`composite_plain` with its coefficient and field
helpers; the column-slab offset ``j0`` left out, since the benchmark
renders whole frames). The composite is the kernels' arithmetic, one
PyTorch operation per step, float32 throughout; the planes are rounded to
the storage type the caller names (:func:`prepare`), which is where the
lower-precision control differs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .common import (EARLY_TERMINATION_ALPHA, VOLUME_DENSITY, clip01,
                     lookup, step_alpha, windowed_tf_range_occupied)

KB = 16  # planes per occupancy chunk
MODES = ("lit", "unlit", "intensity")


@dataclasses.dataclass(frozen=True)
class ShearWarpPlan:
    """Factorization geometry of one (camera, volume) pair.

    Per-plane arrays are ordered front to back; scalars are float32.
    ``msrc_hi``/``mfrac`` are None when planes sit on voxel centers.
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
        return torch.from_numpy(x.astype(np.int64)).to(device)
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


def _volume_planes(vol_t: torch.Tensor, plan: ShearWarpPlan) -> torch.Tensor:
    """Front-to-back (K, D1, D2) sample planes of the axis-permuted volume:
    slice takes, or a two-slice lerp for fractional plane positions."""
    dev = vol_t.device
    if plan.mfrac is None:
        return vol_t[_t(plan.m_src, dev)]
    v0 = vol_t[_t(plan.m_src, dev)]
    v1 = vol_t[_t(plan.msrc_hi, dev)]
    t = _t(plan.mfrac, dev)[:, None, None]
    return v0 * (1.0 - t) + v1 * t


def _resample_matrices(a, b, dim: int, n: int, dtype) -> torch.Tensor:
    """Banded linear-interpolation matrices S (B, dim, n):
    S[p, m, i] = hat(clip(a[p] + b[p] * i, 0, dim - 1) - m)."""
    i = torch.arange(n, dtype=torch.float32, device=a.device)
    v = a[:, None] + b[:, None] * i[None, :]
    vc = v.clamp(0.0, float(dim - 1))
    m = torch.arange(dim, dtype=torch.float32, device=a.device)
    S = (1.0 - (vc[:, None, :] - m[None, :, None]).abs()).clamp(min=0.0)
    return S.to(dtype)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last entry repeated along axis 0 up to ``n`` rows."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])])


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


def _plane_param_array(plan: ShearWarpPlan, Kp: int,
                       extend: bool = False) -> np.ndarray:
    """(5, Kp[+1]) float32 rows a1, b1, a2, b2, lam. Padding planes get
    out-of-range coordinates, so the in-cube mask removes them; ``extend``
    appends one affinely extrapolated plane for the jitter path's k + 1
    reads at the last plane."""
    n = Kp + (1 if extend else 0)
    a2 = plan.a2
    rows = []
    for x, pv in ((plan.a1, -1e9), (plan.b1, 0.0), (a2, -1e9),
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


def in_cube_plain(pa, k: int, gi, gj, jitter, d1: int, d2: int):
    """(in-cube test, λ) of plane k's samples at pixel rows ``gi`` (n1, 1)
    and columns ``gj`` (1, n2), float32: the coordinates a + b * i, lerped
    with plane k + 1 by the per-pixel ``jitter`` where it is given."""
    a1k, b1k, a2k, b2k, lamk = (float(x) for x in pa[:, k])
    v1 = a1k + b1k * gi
    v2 = a2k + b2k * gj
    lam_px = lamk
    if jitter is not None:
        a1n, b1n, a2n, b2n = (float(x) for x in pa[:4, k + 1])
        v1 = v1 + (a1n + b1n * gi - v1) * jitter
        v2 = v2 + (a2n + b2n * gj - v2) * jitter
        lam_px = lamk + float(pa[4, k + 1] - pa[4, k]) * jitter
    return ((v1 >= -0.5) & (v1 <= d1 - 0.5) & (v2 >= -0.5)
            & (v2 <= d2 - 0.5)), lam_px


def composite_plain(W, L, table, pa, occ, e1, step_world, jitter, win,
                    e0: float, early_termination: float, d1: int, d2: int,
                    k_real: int, stats: dict | None = None,
                    checkpoint_planes: int = 0) -> torch.Tensor:
    """Lit front-to-back composite of the (K[+1], n1, n2) planes ``W`` and
    ``L`` -> (4, n1, n2): the kernels' arithmetic, one PyTorch operation
    per step. ``pa`` is the (5, P) host coefficient array, ``occ`` the
    per-chunk occupancy flags (host bools), ``win`` the (4,) window tensor
    (center, width, low, high; it may carry a gradient).

    Every plane is composited, also in a chunk that ``occ`` marks empty:
    its samples add exactly nothing to the frame, but at the TF's alpha
    plateaus (alpha exactly 0, the subgradient 1/2) they do take part in
    the TF's gradient, as in the program's backward.

    ``stats``: if a dict, adds the work these inputs need, in occupied
    chunks only (a kernel skips the others): ``steps``, the (pixel, plane)
    pairs up to the pixel's termination, ``samples``, those that pass the
    mask (whose planes are read), and ``shaded``, those that also pass the
    cutoffs and go through the TF.
    ``checkpoint_planes`` > 0 recomputes each run of that many planes in
    the backward (`torch.utils.checkpoint`), so that a differentiated
    frame fits in memory."""
    dev = e1.device
    n1, n2 = e1.shape
    pa = np.asarray(pa, np.float32)
    gi = torch.arange(n1, dtype=torch.float32, device=dev)[:, None]
    gj = torch.arange(n2, dtype=torch.float32, device=dev)[None, :]
    zeros = torch.zeros((n1, n2), device=dev)
    carry = (zeros, zeros, zeros, zeros,
             torch.zeros((n1, n2), dtype=torch.bool, device=dev))
    if stats is not None:
        for key in ("steps", "samples", "shaded"):
            stats.setdefault(key, 0)
    ks = list(range(k_real))

    def run(ks_run, count, W, L, table, win, rr, rg, rb, alpha, term):
        center, width, low_c, high_c = win[0], win[1], win[2], win[3]
        for k in ks_run:
            cube, lam_px = in_cube_plain(pa, k, gi, gj, jitter, d1, d2)
            value = W[k].float()
            light = L[k].float()
            if jitter is not None:
                value = value + (W[k + 1].float() - value) * jitter
                light = light + (L[k + 1].float() - light) * jitter
            m = cube & ((e0 + lam_px * e1) > 0.0) & ~term
            tf_pos = (value - center + width * 0.5) / width
            cut = (((tf_pos < 0.0) & (low_c > 0.0))
                   | ((tf_pos > 1.0) & (high_c > 0.0)))
            if count and occ[k // KB]:
                stats["steps"] += int((~term).sum())
                stats["samples"] += int(m.sum())
                stats["shaded"] += int((m & ~cut).sum())
            x = tf_pos * 256.0 - 0.5
            i0f = torch.floor(x).detach()
            frac = (x - i0f)[..., None]
            c0 = lookup(table, i0f.clamp(0.0, 255.0).long())
            c1 = lookup(table, (i0f + 1.0).clamp(0.0, 255.0).long())
            c = c0 + (c1 - c0) * frac
            ca = step_alpha(clip01(c[..., 3]), step_world)
            a = torch.where(m & ~cut, ca, zeros)
            w = (1.0 - alpha) * a
            rr = rr + w * c[..., 0] * light
            rg = rg + w * c[..., 1] * light
            rb = rb + w * c[..., 2] * light
            alpha_new = alpha + w
            crossed = (a > 0.0) & (alpha_new > early_termination)
            alpha = torch.where(crossed, torch.ones_like(alpha), alpha_new)
            term = term | crossed
        return rr, rg, rb, alpha, term

    if checkpoint_planes <= 0 or not torch.is_grad_enabled():
        carry = run(ks, stats is not None, W, L, table, win, *carry)
    else:
        from torch.utils.checkpoint import checkpoint

        for s in range(0, len(ks), checkpoint_planes):
            part = ks[s:s + checkpoint_planes]
            if stats is not None:  # counted once, outside the recompute
                with torch.no_grad():
                    run(part, True, W, L, table, win, *carry)
            carry = checkpoint(run, part, False, W, L, table, win, *carry,
                               use_reentrant=False)
    rr, rg, rb, alpha, _ = carry
    return torch.stack([rr, rg, rb, alpha])


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held as float32 (float32: as it is)."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _resample_block(slices, a1, b1, a2, b2, n1: int, n2: int,
                    dtype) -> torch.Tensor:
    """(B, D1, D2) slices -> (B, n1, n2) sheared samples by two batched
    banded float32 matmuls (TF32 off), rounded to the storage ``dtype``."""
    S1 = _resample_matrices(a1, b1, slices.shape[1], n1, torch.float32)
    S2 = _resample_matrices(a2, b2, slices.shape[2], n2, torch.float32)
    t = torch.bmm(S1.transpose(1, 2), slices)
    return _round_to(torch.bmm(t, S2), dtype)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def prepare(volume, table, light_volume, plan: ShearWarpPlan, win,
            clip_center, clip_direction, jitter=None,
            early_termination: float = EARLY_TERMINATION_ALPHA,
            plane_dtype=torch.float32) -> dict:
    """The keyword arguments of :func:`composite_plain` for one lit frame
    (the program's `prepare_composite`): the pre-sheared volume and light
    planes, stored as ``plane_dtype``, edge-padded to the planes the
    jittered composite reads; the per-chunk occupancy; the per-pixel step
    and clip fields; the plane coefficients. ``win`` is a (4,) tensor."""
    dev = volume.device
    n1, n2, K = plan.n1, plan.n2, plan.k
    Kp = _ceil_to(K, KB)
    nch = Kp // KB
    jitter_on = jitter is not None
    Kbuf = Kp + 1 if jitter_on else Kp
    ax = (plan.axis,) + tuple(plan.axes12)

    def coeff(name):
        return _pad_to(_t(getattr(plan, name), dev), Kbuf)

    vplanes = _volume_planes(volume.permute(ax), plan)
    W = _resample_block(_pad_to(vplanes, Kbuf), coeff("a1"), coeff("b1"),
                        coeff("a2"), coeff("b2"), n1, n2, plane_dtype)
    light_t = light_volume.permute(ax)
    lm0 = _t(plan.lm0, dev)
    l0 = light_t[lm0]
    l1 = light_t[(lm0 + 1).clamp(max=light_t.shape[0] - 1)]
    lmt = _t(plan.lmt, dev)[:, None, None]
    lplanes = l0 * (1.0 - lmt) + l1 * lmt
    L = _resample_block(_pad_to(lplanes, Kbuf), coeff("la1"), coeff("lb1"),
                        coeff("la2"), coeff("lb2"), n1, n2, plane_dtype)
    # chunk occupancy: can any value in a chunk's range give alpha > 0?
    inf = torch.tensor([float("inf")], device=dev)
    vp = vplanes.detach()
    sl_mn = torch.cat([vp.amin((1, 2)), inf.expand(Kp - K)])
    sl_mx = torch.cat([vp.amax((1, 2)), -inf.expand(Kp - K)])
    mn_c = sl_mn.view(nch, KB).amin(1)
    mx_c = sl_mx.view(nch, KB).amax(1)
    if jitter_on:  # jittered samples of chunk c lerp into plane (c+1)*KB
        nxt = ((torch.arange(nch, device=dev) + 1) * KB).clamp(max=Kp - 1)
        mn_c = torch.minimum(mn_c, sl_mn[nxt])
        mx_c = torch.maximum(mx_c, sl_mx[nxt])
    w = [float(x) for x in win.detach().tolist()]
    occ = windowed_tf_range_occupied(mn_c, mx_c, w, table.detach())
    step_world, e0, e1 = _clip_step_fields(plan, clip_center, clip_direction,
                                           dev)
    return dict(
        W=W, L=L, table=table, pa=_plane_param_array(plan, Kp,
                                                     extend=jitter_on),
        occ=[bool(x) for x in occ.tolist()], e1=e1, step_world=step_world,
        jitter=jitter, win=win, e0=e0,
        early_termination=float(early_termination),
        d1=volume.shape[plan.axes12[0]], d2=volume.shape[plan.axes12[1]],
        k_real=K)


def intermediate_to_screen(inter: torch.Tensor, plan: ShearWarpPlan,
                           width: int, height: int) -> torch.Tensor:
    """The (4, n1, n2) composite -> the (height, width, 4) frame."""
    return warp_to_screen(inter.permute(1, 2, 0), plan, width, height)
