"""K1: the fused shear-warp composite, with its host glue.

Counterpart of `tbraymarcherplugin_tpu/ops/shearwarp_pallas.py::
shearwarp_intermediate_fused` in its three modes: "lit" (the frame),
"unlit" (the octree mode, with ``sample_nearest``) and "intensity" (first
hit), with the optional per-pixel λ jitter and scene-depth ceiling
``depth_lam``. The glue pre-shears the volume and, in lit mode, the light
volume (K12, `preshear.preshear`; the JAX package leaves this to banded
einsums outside its kernel), computes the per-pixel step and clip fields,
the per-plane coefficients and the per-chunk occupancy flags from the
planes' conservative value ranges; :func:`composite` then launches
`csrc/composite.cu` for CUDA tensors, with each tile's plane interval
from :func:`tile_plane_bounds`, or runs :func:`composite_plain` for CPU
tensors.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.profiling import COMPOSITE, PRESHEAR, TILE_BOUNDS, span
from . import _kernels, preshear
from .compositing import EARLY_TERMINATION_ALPHA
from .sampling import VOLUME_DENSITY
from .shearwarp import (ShearWarpPlan, _resample_matrices, _t,
                        _volume_planes, columns, plane_dtype,
                        rebased_columns)
from .transfer import windowed_tf_range_occupied

KB = 16  # planes per occupancy chunk
MODES = ("lit", "unlit", "intensity")  # csrc/composite.cu's MODE_* order
# csrc/composite_tile.cuh: a warp's tile is 32 pixels of one row; K1 and K5
# take their tile's plane interval from tile_plane_bounds
TILE = (1, 32)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _axis_ok(a, b, n: int, th: int, dim: int, jitter: bool) -> np.ndarray:
    """(tiles, K) bool: does some pixel row (column) of each tile of ``th``
    rows (columns) of ``n`` lie in [-0.5, dim - 0.5] at plane k? The
    coordinate a[k] + b[k] * i rounds as the kernels round it (float32, one
    rounding per operation), which is monotone in i, so its range over a
    tile is the range of its first and last row. With ``jitter`` plane k
    spans the hull of planes k and k + 1 (its samples lerp between them),
    and ``a``, ``b`` hold K + 1 planes."""
    lo = np.arange(0, n, th, dtype=np.float32)
    hi = np.minimum(lo + np.float32(th - 1), np.float32(n - 1))
    va = a[None, :] + b[None, :] * lo[:, None]
    vb = a[None, :] + b[None, :] * hi[:, None]
    vmin, vmax = np.minimum(va, vb), np.maximum(va, vb)
    if jitter:
        vmin = np.minimum(vmin[:, :-1], vmin[:, 1:])
        vmax = np.maximum(vmax[:, :-1], vmax[:, 1:])
    top = np.float32(dim) - np.float32(0.5)
    return (vmax >= np.float32(-0.5)) & (vmin <= top)


def _interval(ok: np.ndarray):
    """Per row of ``ok`` (tiles, K): its first true index and one past its
    last (0, 0 where none), and whether the trues are contiguous."""
    K = ok.shape[1]
    anyv = ok.any(axis=1)
    lo = np.where(anyv, ok.argmax(axis=1), 0)
    hi = np.where(anyv, K - ok[:, ::-1].argmax(axis=1), 0)
    contiguous = ok.sum(axis=1) == hi - lo
    return lo, hi, contiguous


def tile_plane_bounds(pa, n1: int, n2: int, d1: int, d2: int, k_real: int,
                      tile=TILE, jitter: bool = False) -> np.ndarray:
    """(n1 / th, n2 / tw, 2) int32 [k_lo, k_hi) per (th, tw) tile of the
    intermediate image, ragged edge tiles included: the smallest interval
    of planes k < ``k_real`` holding every plane whose in-cube test can pass
    for some pixel of the tile (the JAX package's `_geo_chunk_validity` and
    `_bounds_from_validity` at plane granularity). Pure geometry: the clip
    plane, a λ ceiling and occupancy only mask more. ``pa`` is the (5, P)
    coefficient array a1, b1, a2, b2, lam; with ``jitter`` (the sample of
    plane k lies between planes k and k + 1) it must hold plane
    ``k_real``, as composite's extended array does. Where the JAX package
    unions per plane "both axes in at k or both in at k + 1", this takes
    each axis's hull over k and k + 1, which also keeps a sample whose ray
    clips a corner of the cube between two planes."""
    th, tw = tile
    pa = np.asarray(pa, np.float32)
    n = k_real + (1 if jitter else 0)
    if pa.shape[1] < n:
        raise ValueError(f"pa holds {pa.shape[1]} planes, need {n}")
    ok1 = _axis_ok(pa[0, :n], pa[1, :n], n1, th, d1, jitter)
    ok2 = _axis_ok(pa[2, :n], pa[3, :n], n2, tw, d2, jitter)
    lo1, hi1, c1 = _interval(ok1)
    lo2, hi2, c2 = _interval(ok2)
    if c1.all() and c2.all():  # the intersection of two intervals
        lo = np.maximum(lo1[:, None], lo2[None, :])
        hi = np.minimum(hi1[:, None], hi2[None, :])
        empty = lo >= hi
        lo, hi = np.where(empty, 0, lo), np.where(empty, 0, hi)
    else:
        ok = ok1[:, None, :] & ok2[None, :, :]
        shape = ok.shape[:2]
        lo, hi, _ = _interval(ok.reshape(-1, ok.shape[2]))
        lo, hi = lo.reshape(shape), hi.reshape(shape)
    return np.stack([lo, hi], axis=-1).astype(np.int32)


_BOUNDS_CACHE: collections.OrderedDict = collections.OrderedDict()


def tile_bounds_tensor(pa, n1: int, n2: int, d1: int, d2: int, k_real: int,
                       jitter: bool, device) -> torch.Tensor:
    """:func:`tile_plane_bounds` at the kernels' tile, as an int32 tensor
    on ``device``; the last few are kept, so that the frames and steps of
    one plan compute and upload it once."""
    pa = np.ascontiguousarray(pa, np.float32)
    key = (pa.tobytes(), pa.shape, n1, n2, d1, d2, k_real, jitter, str(device))
    t = _BOUNDS_CACHE.get(key)
    if t is None:
        with span(TILE_BOUNDS):
            t = to_device(tile_plane_bounds(
                pa, n1, n2, d1, d2, k_real, TILE, jitter), device)
        _BOUNDS_CACHE[key] = t
        while len(_BOUNDS_CACHE) > 8:
            _BOUNDS_CACHE.popitem(last=False)
    else:
        _BOUNDS_CACHE.move_to_end(key)
    return t


def variant(mode: str, depth_lam=None) -> str:
    """The name a launch of K1 counts under in
    ``composite.variant_launches``: "composite" for lit mode,
    "composite_<mode>" otherwise, "_depth" appended with a λ ceiling."""
    name = "composite" if mode == "lit" else f"composite_{mode}"
    return name if depth_lam is None else name + "_depth"


def _plane_param_array(plan: ShearWarpPlan, Kp: int,
                       extend: bool = False) -> np.ndarray:
    """(5, Kp[+1]) float32 rows a1, b1, a2, b2, lam. Padding planes get
    out-of-range coordinates, so the in-cube mask removes them; ``extend``
    appends one affinely extrapolated plane for the jitter path's k + 1
    reads at the last plane."""
    n = Kp + (1 if extend else 0)
    # a column slab's kernels count local columns: a2 re-based to them
    a2 = rebased_columns(plan)[0] if plan.j0 else plan.a2
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
    jj = columns(plan, device)
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


def composite_plain(W, L, tf_table, pa, occ, e1, step_world, jitter, win,
                    e0: float, early_termination: float, d1: int, d2: int,
                    k_real: int, depth_lam=None, mode: str = "lit",
                    stats: dict | None = None) -> torch.Tensor:
    """Front-to-back composite of the (K[+1], n1, n2) planes ``W`` (and
    ``L``, lit mode only) -> (4, n1, n2); the kernel's arithmetic, one
    PyTorch operation per step. ``pa`` is the (5, P) host coefficient
    array, ``occ`` the per-chunk occupancy flags, ``win`` the (4,) window
    (center, width, low, high) and ``depth_lam`` an optional (n1, n2) λ
    ceiling, tensors on the planes' device. ``mode``: see the module
    docstring; intensity gives (g, g, g, hit).

    ``stats``: if a dict, adds the work these inputs need: ``steps``, the
    (pixel, plane) pairs of occupied chunks up to the pixel's termination
    (what a thread that visits every plane does; the kernel skips those
    outside its tile's interval, `tile_plane_bounds`), ``samples``, those
    that pass the mask (whose planes are read), and ``shaded``, those that
    also pass the cutoffs and go through the TF (never in intensity
    mode)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose {MODES}")
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
    if stats is not None:
        for key in ("steps", "samples", "shaded"):
            stats.setdefault(key, 0)
    for k in range(k_real):
        if not occ[k // KB]:
            continue
        cube, lam_px = in_cube_plain(pa, k, gi, gj, jitter, d1, d2)
        value = W[k].float()
        if jitter is not None:
            value = value + (W[k + 1].float() - value) * jitter
        m = cube & ((e0 + lam_px * e1) > 0.0) & ~term
        if depth_lam is not None:
            m = m & (lam_px <= depth_lam)
        # by the width as a tensor: PyTorch divides a CUDA tensor by a
        # Python number as a product with its reciprocal, an ulp off the
        # kernel's division, which can flip a pixel's 0.95 snap
        tf_pos = (value - center + width * 0.5) / win[1]
        if stats is not None:
            stats["steps"] += int((~term).sum())
            stats["samples"] += int(m.sum())
        if mode == "intensity":  # the first sample that passes the mask
            rr = torch.where(m, tf_pos.clamp(0.0, 1.0), rr)
            term = term | m
            continue
        cut = (((tf_pos < 0.0) & (low_c > 0.0))
               | ((tf_pos > 1.0) & (high_c > 0.0)))
        if stats is not None:
            stats["shaded"] += int((m & ~cut).sum())
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
        wr, wg, wb = w * c[..., 0], w * c[..., 1], w * c[..., 2]
        if mode == "lit":
            light = L[k].float()
            if jitter is not None:
                light = light + (L[k + 1].float() - light) * jitter
            wr, wg, wb = wr * light, wg * light, wb * light
        rr, rg, rb = rr + wr, rg + wg, rb + wb
        alpha_new = alpha + w
        crossed = (a > 0.0) & (alpha_new > early_termination)
        alpha = torch.where(crossed, torch.ones_like(alpha), alpha_new)
        term = term | crossed
    if mode == "intensity":
        return torch.stack([rr, rr, rr, term.to(torch.float32)])
    return torch.stack([rr, rg, rb, alpha])


def composite(W, L, tf_table, pa, occ, e1, step_world, jitter, win,
              e0: float, early_termination: float, d1: int, d2: int,
              k_real: int, depth_lam=None, mode: str = "lit") -> torch.Tensor:
    """Composite -> (4, n1, n2); see :func:`composite_plain`. Counts each
    launch in ``composite.launches`` and, under :func:`variant`'s name, in
    ``composite.variant_launches``."""
    if W.device.type == "cpu":
        with span(COMPOSITE):
            return composite_plain(W, L, tf_table, pa, occ, e1, step_world,
                                   jitter, win, e0, early_termination, d1,
                                   d2, k_real, depth_lam, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose {MODES}")
    dev = W.device
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"W must be float32 or bfloat16, got {W.dtype}")
    if tuple(tf_table.shape) != (256, 4):
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    lit = mode == "lit"
    if lit == (L is None):
        raise ValueError("L is read in lit mode only: pass it there, and "
                         "None otherwise")
    n1, n2 = e1.shape
    pa_host = np.asarray(pa, np.float32)
    pa = to_device(pa_host, dev).contiguous()
    P = pa.shape[1]
    need = k_real + (1 if jitter is not None else 0)
    if W.shape[0] < need or (lit and L.shape[0] < need) or P < need:
        raise ValueError("planes or coefficients shorter than K (+1 jitter)")
    if occ.numel() * KB < k_real:
        raise ValueError("occupancy flags do not cover every plane")
    if win.numel() != 4:
        raise ValueError(f"win must hold 4 values, got {win.numel()}")
    tensors = dict(W=W, tf_table=tf_table, e1=e1, step_world=step_world,
                   occ=occ, win=win)
    for name, t in (("L", L), ("jitter", jitter), ("depth_lam", depth_lam)):
        if t is not None:
            tensors[name] = t
    for name, t in tensors.items():
        dtype = {"W": W.dtype, "L": W.dtype, "occ": torch.int32}.get(
            name, torch.float32)
        _kernels.check(t, name, dtype, dev)
    for name, t in tensors.items():
        if name in ("W", "L") and t.shape[1:] != (n1, n2):
            raise ValueError(f"{name} and the per-pixel fields differ in "
                             f"shape")
        if name in ("jitter", "depth_lam") and t.shape != (n1, n2):
            raise ValueError(f"{name} must be ({n1}, {n2})")
    bounds = tile_bounds_tensor(pa_host, n1, n2, d1, d2, k_real,
                                jitter is not None, dev)
    out = torch.empty((4, n1, n2), dtype=torch.float32, device=dev)
    name = "tbr_composite_bf16" if W.dtype == torch.bfloat16 \
        else "tbr_composite_f32"

    def ptr(t):
        return None if t is None else t.data_ptr()

    with span(COMPOSITE):
        _kernels.launch(
            name, W.data_ptr(), ptr(L), tf_table.data_ptr(), pa.data_ptr(),
            occ.data_ptr(), bounds.data_ptr(), e1.data_ptr(),
            step_world.data_ptr(), ptr(jitter), ptr(depth_lam),
            win.data_ptr(), out.data_ptr(), n1, n2, k_real, P, occ.numel(),
            MODES.index(mode), e0, early_termination, float(d1), float(d2),
            _kernels.stream_of(W),
        )
    composite.launches += 1
    composite.variant_launches[variant(mode, depth_lam)] += 1
    return out


composite.launches = 0
composite.variant_launches = collections.Counter()


def prepare_composite(volume, tf_table, light_volume, plan: ShearWarpPlan,
                      windowing_vec4, clip_center, clip_direction,
                      early_termination: float = EARLY_TERMINATION_ALPHA,
                      compute_dtype=None, jitter=None, depth_lam=None,
                      mode: str = "lit", sample_nearest: bool = False,
                      slice_range=None) -> dict:
    """The keyword arguments of :func:`composite` for one frame.

    ``compute_dtype`` is the storage type of the pre-sheared planes (None:
    `shearwarp.plane_dtype`'s, bfloat16 on the card and float32 on the
    CPU). ``jitter``: optional (n1, n2) per-pixel lam phase in [0, 1).
    ``depth_lam``: optional (n1, n2) λ ceiling
    (`shearwarp.depth_to_lambda_max`). ``mode``: "lit", "unlit" or
    "intensity"; the light planes are built in lit mode only
    (``light_volume`` is not read otherwise), and in intensity mode every
    chunk counts as occupied (a hit needs no alpha), elsewhere the chunks'
    value ranges come from the volume's per-slice ranges
    (`preshear.plane_value_ranges`): ``slice_range``, the volume's
    `preshear.slice_ranges` across ``plan.axis`` where the caller keeps
    them (the Renderer), else reduced here. ``sample_nearest``: the
    pre-shear selects the nearest texel (the octree mode).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose {MODES}")
    dev = volume.device
    compute_dtype = plane_dtype(compute_dtype, dev)
    K = plan.k
    Kbuf = _ceil_to(K, KB) + (1 if jitter is not None else 0)

    # The streams are edge-padded to Kbuf planes (the jittered last plane
    # lerps toward a copy of itself; other padding is masked): the planes
    # past K repeat the last plane's slices and coefficients.
    lit = mode == "lit"
    with span(PRESHEAR):  # K12, looked up at call time
        vs, ls = preshear.plan_streams(plan, Kbuf, volume.shape,
                                       light_volume.shape if lit else None,
                                       sample_nearest, dev)
        W = preshear.preshear(volume, vs, compute_dtype)
        L = preshear.preshear(light_volume, ls, compute_dtype) if lit \
            else None

    value_range = None
    if mode != "intensity":  # plan data: it takes no gradient
        if slice_range is None:
            slice_range = preshear.slice_ranges(volume, plan.axis)
        value_range = preshear.plane_value_ranges(slice_range, vs, K)
    return composite_args(
        plan, W, L, tf_table, windowing_vec4, value_range, clip_center,
        clip_direction, early_termination, jitter, depth_lam, mode,
        volume.shape[plan.axes12[0]], volume.shape[plan.axes12[1]])


def composite_args(plan: ShearWarpPlan, W, L, tf_table, windowing_vec4,
                   value_range, clip_center, clip_direction,
                   early_termination: float = EARLY_TERMINATION_ALPHA,
                   jitter=None, depth_lam=None, mode: str = "lit",
                   d1: int = 0, d2: int = 0) -> dict:
    """The keyword arguments of :func:`composite` from the pre-sheared
    planes ``W`` and ``L`` of ``plan`` (its columns: a column band's plan
    takes the band's planes, jitter and λ ceiling): ``value_range`` is
    each plane's (min, max) of volume values, (K,) each, for the chunk
    occupancy (None in intensity mode, where every chunk counts); ``d1``,
    ``d2`` the volume's sizes along ``plan.axes12``. See
    :func:`prepare_composite`."""
    dev = W.device
    K = plan.k
    Kp = _ceil_to(K, KB)
    nch = Kp // KB
    jitter_on = jitter is not None
    win = to_device(windowing_vec4, dev, torch.float32)
    if mode == "intensity":
        occ = torch.ones(nch, dtype=torch.bool, device=dev)
    else:
        # Chunk occupancy: can any value in a chunk's range give alpha > 0?
        inf = to_device([float("inf")], dev)
        sl_mn = torch.cat([value_range[0], inf.expand(Kp - K)])
        sl_mx = torch.cat([value_range[1], -inf.expand(Kp - K)])
        mn_c = sl_mn.view(nch, KB).amin(1)
        mx_c = sl_mx.view(nch, KB).amax(1)
        if jitter_on:  # jittered samples of chunk c lerp into plane (c+1)*KB
            nxt = ((torch.arange(nch, device=dev) + 1) * KB).clamp(max=Kp - 1)
            mn_c = torch.minimum(mn_c, sl_mn[nxt])
            mx_c = torch.maximum(mx_c, sl_mx[nxt])
        occ = windowed_tf_range_occupied(mn_c, mx_c, win.detach(),
                                         tf_table.detach())

    step_world, e0, e1 = _clip_step_fields(plan, clip_center, clip_direction,
                                           dev)
    ops = dict(
        W=W, L=L, tf_table=tf_table.contiguous(),
        pa=_plane_param_array(plan, Kp, extend=jitter_on),
        occ=occ.to(torch.int32).contiguous(), e1=e1, step_world=step_world,
        jitter=None if jitter is None else jitter.contiguous(),
        win=win.contiguous(), e0=e0,
        early_termination=float(early_termination), d1=d1, d2=d2, k_real=K,
    )
    # a lit frame without a λ ceiling keeps composite's defaults, so that
    # its arguments are also those of the backward (shearwarp_grad)
    if depth_lam is not None:
        ops["depth_lam"] = to_device(depth_lam, dev,
                                     torch.float32).contiguous()
    if mode != "lit":
        ops["mode"] = mode
    return ops


# the planes a slab's pre-shear resamples at a time
SLAB_PRESHEAR_BLOCK = 16


def _own(idx: np.ndarray, z0: int, z1: int) -> np.ndarray:
    return (idx >= z0) & (idx < z1)


def _slab_lerp(vol_t, m0, m1, t, z0: int, z1: int, block):
    """This slab's share of the planes ``block`` of the lerp
    ``v[m0] (1 - t) + v[m1] t`` of the Z slices of ``vol_t`` (Zc, A, B),
    the slab's planes z0 .. z1 - 1: the terms of the slices it owns, 0
    for the others (``m1`` None: the slices ``m0`` alone). A plane both
    of whose slices it owns is the lerp's own arithmetic."""
    dev = vol_t.device
    zc = vol_t.shape[0]

    def term(m):
        own = torch.from_numpy(_own(m[block], z0, z1)).to(dev)
        idx = torch.from_numpy(np.clip(m[block] - z0, 0, zc - 1)).to(dev)
        return vol_t[idx] * own[:, None, None].to(vol_t.dtype)

    if m1 is None:
        return term(m0)
    tt = _t(t[block], dev)[:, None, None]
    return term(m0) * (1.0 - tt) + term(m1) * tt


def _slice_range(vol_t, m0, m1, t, z0: int, z1: int):
    """(K,) conservative (min, max) of each plane's values from the Z
    slices this slab owns with a positive weight (+-inf where none): a
    lerp's value lies between its two slices', up to an ulp, which the
    range is widened by."""
    dev = vol_t.device
    smn, smx = vol_t.amin((1, 2)), vol_t.amax((1, 2))
    inf = torch.tensor(float("inf"), device=dev)
    zc = vol_t.shape[0]
    mn = inf.expand(len(m0)).clone()
    mx = -mn
    terms = [(m0, None if t is None else t < 1.0)]
    if m1 is not None:
        terms.append((m1, t > 0.0))
    for m, w in terms:
        own = _own(m, z0, z1) & (True if w is None else w)
        sel = torch.from_numpy(own).to(dev)
        idx = torch.from_numpy(np.clip(m - z0, 0, zc - 1)).to(dev)
        mn = torch.where(sel, torch.minimum(mn, smn[idx]), mn)
        mx = torch.where(sel, torch.maximum(mx, smx[idx]), mx)
    return (torch.nextafter(mn, -inf), torch.nextafter(mx, inf))


def preshear_slab(volume, light_volume, plan: ShearWarpPlan, dims,
                  light_dims, z0: int, lz0: int, bands: int,
                  jitter_on: bool):
    """This slab's partial sums of every plane of ``plan``'s pre-shear:
    the terms of the resample over the volume's Z planes z0 .. z0 + Zc - 1
    it holds (``volume``, (X, Y, Zc), a slab of a volume of ``dims``; the
    light chunk ``light_volume`` from light plane ``lz0`` of
    ``light_dims``), float32, so that the slabs' partial planes add up to
    the whole volume's pre-shear, each bilinear tap counted by the slab
    that owns it. Returns (W, L, (mn, mx)): the partial volume and light
    planes as (bands, Kbuf, n1, n2 / bands), the planes' column bands in
    turn (a reduce-scatter's chunks), and each plane's conservative value
    range over the slab (:func:`_slice_range`; (K,) each). A principal
    axis along X or Y (Z one of the plane's axes) takes the slab's rows of
    the column taps; one along Z its slices' share of each plane's lerp
    (:func:`_slab_lerp`). Made :data:`SLAB_PRESHEAR_BLOCK` planes at a
    time."""
    dev = volume.device
    f32 = torch.float32
    n1, n2, K = plan.n1, plan.n2, plan.k
    nb = n2 // bands
    Kbuf = _ceil_to(K, KB) + (1 if jitter_on else 0)
    zc, lzc = volume.shape[2], light_volume.shape[2]
    ax = (plan.axis,) + tuple(plan.axes12)

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], Kbuf - len(x), 0)])

    def coeff(name):
        return _t(pad(np.asarray(getattr(plan, name))), dev)

    W = torch.empty((bands, Kbuf, n1, nb), dtype=f32, device=dev)
    L = torch.empty_like(W)
    idx = pad(np.arange(K))
    if plan.axis != 2:  # Z is the planes' second axis: the slab's rows
        vplanes = _volume_planes(volume.permute(ax), plan)
        rng = (vplanes.amin((1, 2)), vplanes.amax((1, 2)))
        light_t = light_volume.permute(ax)
        lm0 = _t(plan.lm0, dev)
        lmt = _t(plan.lmt, dev)[:, None, None]
        lplanes = (light_t[lm0] * (1.0 - lmt) + light_t[
            (lm0 + 1).clamp(max=light_t.shape[0] - 1)] * lmt)
        rows = {"v": (z0, z0 + zc), "l": (lz0, lz0 + lzc)}

        def planes(kind, block):
            return (vplanes if kind == "v" else lplanes)[
                torch.from_numpy(idx[block]).to(dev)]
    else:  # the planes are Z slices: the slab's share of each lerp
        vol_t = volume.permute(ax)
        light_t = light_volume.permute(ax)
        m0, m1, t = plan.m_src, plan.msrc_hi, plan.mfrac
        rng = _slice_range(vol_t, m0, m1, t, z0, z0 + zc)
        lm1 = np.minimum(plan.lm0 + 1, light_dims[2] - 1)
        rows = {"v": None, "l": None}
        src = {"v": (vol_t, pad(m0), None if m1 is None else pad(m1),
                     None if t is None else pad(t), z0, z0 + zc),
               "l": (light_t, pad(plan.lm0), pad(lm1), pad(plan.lmt), lz0,
                     lz0 + lzc)}

        def planes(kind, block):
            return _slab_lerp(*src[kind][:4], *src[kind][4:], block)
    d = {"v": (dims[plan.axes12[0]], dims[plan.axes12[1]]),
         "l": (light_dims[plan.axes12[0]], light_dims[plan.axes12[1]])}
    names = {"v": ("a1", "b1", "a2", "b2"), "l": ("la1", "lb1", "la2",
                                                 "lb2")}
    for k0 in range(0, Kbuf, SLAB_PRESHEAR_BLOCK):
        block = slice(k0, min(k0 + SLAB_PRESHEAR_BLOCK, Kbuf))
        for kind, out in (("v", W), ("l", L)):
            a1, b1, a2, b2 = (coeff(nm)[block] for nm in names[kind])
            sl = planes(kind, block).to(f32)
            S1 = _resample_matrices(a1, b1, d[kind][0], n1, f32)
            S2 = _resample_matrices(a2, b2, d[kind][1], n2, f32,
                                    rows=rows[kind])
            tb = torch.bmm(S1.transpose(1, 2), sl)
            for b in range(bands):
                torch.bmm(tb, S2[:, :, b * nb:(b + 1) * nb],
                          out=out[b, block])
    return W, L, rng


def shearwarp_intermediate_fused(volume, tf_table, light_volume,
                                 plan: ShearWarpPlan, windowing_vec4,
                                 clip_center, clip_direction,
                                 early_termination: float = EARLY_TERMINATION_ALPHA,
                                 compute_dtype=None, jitter=None,
                                 depth_lam=None, mode: str = "lit",
                                 sample_nearest: bool = False,
                                 slice_range=None) -> torch.Tensor:
    """Shear-warp composite -> (4, n1, n2), the layout
    `warp.warp_to_screen_fused` reads; see :func:`prepare_composite`
    (``light_volume`` may be None outside lit mode)."""
    ops = prepare_composite(volume, tf_table, light_volume, plan,
                            windowing_vec4, clip_center, clip_direction,
                            early_termination, compute_dtype, jitter,
                            depth_lam, mode, sample_nearest, slice_range)
    return composite(**ops)
