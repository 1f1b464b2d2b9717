"""K5: the backward of the lit shear-warp composite, and the differentiable
fused composite.

Counterpart of `tbraymarcherplugin_tpu/ops/shearwarp_grad.py`.
:func:`shearwarp_intermediate_fused_diff` pre-shears the volume and light
planes with plain PyTorch (autograd carries their cotangents back to the
volume and the light volume) and composites them through
:func:`fused_composite`, whose forward is kernel K1 without jitter
(`composite.composite`) and whose backward is :func:`composite_bwd`: it
launches `csrc/composite_bwd.cu` for CUDA tensors and runs
:func:`composite_bwd_plain` for CPU tensors. Cotangents flow to the planes
W and L, the TF table and the window (center, width); the rest is plan
geometry.

Gradient semantics are the JAX package's (its oracle is XLA autodiff of
the dense composite): the masks, the cutoffs and the 0.95
early-termination snap are constants, and the clip of the TF alpha takes
the 0.5 subgradient at exact ties. With bf16 planes the cotangents of W and
L are rounded to bf16, as the JAX package rounds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import COMPOSITE_BWD, span
from . import _kernels
from . import composite as C
from .compositing import EARLY_TERMINATION_ALPHA
from .shearwarp import ShearWarpPlan
from .tf_alpha import _assemble, _clip_grad
from .tf_alpha import warp_rounds

_NT = 4 * 256  # K5's d TF row: [channel(4)][texel(256)]
_ROW = _NT + 2  # + d center, d width
GROUP = 8  # csrc/composite_tile.cuh: planes per alpha checkpoint


def _dtf_dwin(hist, dc, dw):
    """(2, 4, 256) tap histograms and the center/width sums -> d TF
    (256, 4), d window (4,)."""
    dtf = _assemble(hist[0], hist[1]).T.contiguous()
    zero = torch.zeros((), dtype=torch.float32, device=hist.device)
    return dtf, torch.stack([dc, dw, zero, zero])


def _add_clustering(ia, hit, acc: dict) -> None:
    """Add to ``acc`` how one plane's histogram adds cluster: ``ia`` the
    flat floor texels of the plane's pixels, ``hit`` where a pixel adds;
    the rounds of each warp of 32 consecutive pixels
    (`tf_alpha.warp_rounds`); a run is a maximal sequence of consecutive
    hitting pixels on one texel."""
    if ia.numel() == 0:
        return
    rounds = warp_rounds(ia, hit)
    cont = hit[1:] & hit[:-1] & (ia[1:] == ia[:-1])  # a run goes on
    hits = int(hit.sum())
    for key, v in (("pixels", ia.numel()), ("hits", hits),
                   ("warps", rounds.numel()),
                   ("warps_hit", int((rounds > 0).sum())),
                   ("rounds", int(rounds.sum())),
                   ("runs", hits - int(cont.sum()))):
        acc[key] = acc.get(key, 0) + v
    acc["rounds_max"] = max(acc.get("rounds_max", 0), int(rounds.max()))


def clustering_summary(acc: dict) -> dict:
    """``hit``, the share of (pixel, plane) pairs that add to the d TF
    histogram; ``rounds_mean`` over the (warp, plane) pairs with a hit and
    ``rounds_max``; ``run_mean``, hits per run; from the sums
    :func:`composite_bwd_plain` fills in its ``stats``."""
    return dict(hit=acc["hits"] / max(acc["pixels"], 1),
                rounds_mean=acc["rounds"] / max(acc["warps_hit"], 1),
                rounds_max=acc["rounds_max"],
                run_mean=acc["hits"] / max(acc["runs"], 1))


def composite_bwd_plain(W, L, tf_table, pa, e1, step_world, win, g, e0: float,
                        early_termination: float, d1: int, d2: int,
                        k_real: int, stats: dict | None = None):
    """Cotangents of the lit composite (:func:`composite.composite_plain`
    without jitter) for the (4, n1, n2) output cotangent ``g``: (dW, dL in
    the planes' type and shape, d TF (256, 4), d window (4,)); the kernel's
    arithmetic, one PyTorch operation per step over the (n1, n2) plane.

    ``stats``: if a dict, adds how the d TF histogram's adds cluster, plane
    by plane, over the planes' flat pixels: the sums ``pixels``, ``hits``
    (pixels whose sample is alive, in the cube and not cut), ``warps``,
    ``warps_hit``, ``rounds``, ``runs`` and the largest ``rounds_max``
    (see :func:`clustering_summary`)."""
    dev = e1.device
    f32 = torch.float32
    center, width, low_c, high_c = win[0], win[1], win[2], win[3]
    n1, n2 = e1.shape
    pa = np.asarray(pa, np.float32)
    gi = torch.arange(n1, dtype=f32, device=dev)[:, None]
    gj = torch.arange(n2, dtype=f32, device=dev)[None, :]

    def sample(k):
        a1k, b1k, a2k, b2k, lamk = (float(x) for x in pa[:, k])
        v1 = a1k + b1k * gi
        v2 = a2k + b2k * gj
        m = ((v1 >= -0.5) & (v1 <= d1 - 0.5) & (v2 >= -0.5)
             & (v2 <= d2 - 0.5) & ((e0 + lamk * e1) > 0.0))
        tf_pos = (W[k].float() - center + width * 0.5) / width
        cut = (((tf_pos < 0.0) & (low_c > 0.0))
               | ((tf_pos > 1.0) & (high_c > 0.0)))
        x = tf_pos * 256.0 - 0.5
        i0f = torch.floor(x)
        frac = x - i0f
        ia = i0f.clamp(0.0, 255.0).long()
        ib = (i0f + 1.0).clamp(0.0, 255.0).long()
        return m & ~cut, tf_pos, x, frac, ia, tf_table[ia], tf_table[ib]

    def correct(a_raw):
        one_m = 1.0 - a_raw.clamp(0.0, 1.0)
        logb = torch.log(torch.clamp(one_m, min=1e-10))
        corr = 1.0 - torch.exp(step_world * logb)
        dcorr = (step_world * torch.exp((step_world - 1.0) * logb)
                 * (one_m >= 1e-10).to(f32))
        return corr, dcorr

    # sweep 1: the forward recurrence; T[k] = T_{k-1}
    alpha = torch.zeros((n1, n2), device=dev)
    term = torch.zeros((n1, n2), dtype=torch.bool, device=dev)
    T = []
    for k in range(k_real):
        T.append(1.0 - alpha)
        gate, _, _, frac, _, c0, c1 = sample(k)
        a_raw = c0[..., 3] + (c1[..., 3] - c0[..., 3]) * frac
        a = torch.where(gate & ~term, correct(a_raw)[0],
                        torch.zeros_like(alpha))
        alpha_new = alpha + (1.0 - alpha) * a
        crossed = (a > 0.0) & (alpha_new > early_termination)
        alpha = torch.where(crossed, torch.ones_like(alpha), alpha_new)
        term = term | crossed

    # sweep 2: k descending
    g0, g1, g2 = g[0], g[1], g[2]
    galpha = g[3] * (~term).to(f32)
    U = torch.zeros((n1, n2), device=dev)
    V = torch.ones((n1, n2), device=dev)
    dW = torch.zeros(W.shape, dtype=f32, device=dev)
    dL = torch.zeros(L.shape, dtype=f32, device=dev)
    hist = torch.zeros((2, 4, 256), dtype=f32, device=dev)
    dc = torch.zeros((), device=dev)
    dw = torch.zeros((), device=dev)
    for k in range(k_real - 1, -1, -1):
        Tk = T[k]
        gate, tf_pos, x, frac, ia, c0, c1 = sample(k)
        light = L[k].float()
        c = c0 + (c1 - c0) * frac[..., None]
        cr, cg, cb, a_raw = c.unbind(-1)
        corr, dcorr = correct(a_raw)
        gatef = (gate & (Tk > 0.0)).to(f32)
        a_eff = gatef * corr
        gl = g0 * cr + g1 * cg + g2 * cb
        P = gl * light
        da = Tk * (P - U + galpha * V)
        w_ = Tk * a_eff
        ger = g0 * w_ * light
        geg = g1 * w_ * light
        geb = g2 * w_ * light
        ga = da * gatef * dcorr * _clip_grad(a_raw)
        slope = c1 - c0
        gx = (ger * slope[..., 0] + geg * slope[..., 1] + geb * slope[..., 2]
              + ga * slope[..., 3])
        dW[k] = gx * (256.0 / width)
        dL[k] = w_ * gl
        dc = dc + (gx * (-256.0 / width)).sum()
        dw = dw + (gx * (256.0 * (0.5 - tf_pos) / width)).sum()
        in_rng = (x >= 0.0) & (x < 255.0)
        wa = torch.where(in_rng, 1.0 - frac, torch.ones_like(frac))
        wb = torch.where(in_rng, frac, torch.zeros_like(frac))
        for t, wt in enumerate((wa, wb)):
            for ch, ge in enumerate((ger, geg, geb, ga)):
                hist[t, ch].index_add_(0, ia.flatten(), (ge * wt).flatten())
        if stats is not None:
            _add_clustering(ia.flatten(), (gatef > 0.0).flatten(), stats)
        U = a_eff * P + (1.0 - a_eff) * U
        V = (1.0 - a_eff) * V
    dtf, dwin = _dtf_dwin(hist, dc, dw)
    return dW.to(W.dtype), dL.to(L.dtype), dtf, dwin


def composite_bwd(W, L, tf_table, pa, e1, step_world, win, g, e0: float,
                  early_termination: float, d1: int, d2: int, k_real: int):
    """Cotangents of the lit composite; see :func:`composite_bwd_plain`.
    The histogram and the window sums reduce in a fixed order: the same
    bits on every run."""
    if W.device.type == "cpu":
        return composite_bwd_plain(W, L, tf_table, pa, e1, step_world, win, g,
                                   e0, early_termination, d1, d2, k_real)
    dev = W.device
    if W.dtype not in (torch.float32, torch.bfloat16) or L.dtype != W.dtype:
        raise ValueError(f"W and L must share float32 or bfloat16, got "
                         f"{W.dtype}, {L.dtype}")
    n1, n2 = e1.shape
    W, L, g = W.contiguous(), L.contiguous(), g.contiguous()
    tf_table = tf_table.contiguous()
    pa_host = np.asarray(pa, np.float32)
    pa = torch.as_tensor(pa_host, device=dev).contiguous()
    P = pa.shape[1]
    kp = W.shape[0]
    if (tuple(tf_table.shape) != (256, 4) or tuple(g.shape) != (4, n1, n2)
            or W.shape != L.shape or tuple(W.shape[1:]) != (n1, n2)
            or win.numel() != 4 or P < k_real or kp < k_real):
        raise ValueError("composite_bwd: inconsistent shapes")
    for name, t in (("W", W), ("L", L)):
        _kernels.check(t, name, W.dtype, dev)
    for name, t in (("tf_table", tf_table), ("e1", e1),
                    ("step_world", step_world), ("win", win), ("g", g)):
        _kernels.check(t, name, torch.float32, dev)
    bf16 = W.dtype == torch.bfloat16
    blocks = _blocks(n1, n2)
    bounds = C.tile_bounds_tensor(pa_host, n1, n2, d1, d2, k_real, False,
                                  dev)
    # alpha at the start of each group of GROUP planes (no T scratch)
    ckpt = torch.empty((-(-k_real // GROUP), n1, n2), dtype=torch.float32,
                       device=dev)
    dW = torch.empty_like(W)
    dL = torch.empty_like(L)
    partials = torch.empty((blocks, _ROW), dtype=torch.float32, device=dev)
    name = "tbr_composite_bwd_bf16" if bf16 else "tbr_composite_bwd_f32"
    _kernels.launch(
        name, W.data_ptr(), L.data_ptr(), tf_table.data_ptr(), pa.data_ptr(),
        bounds.data_ptr(), e1.data_ptr(), step_world.data_ptr(),
        win.data_ptr(), g.data_ptr(), ckpt.data_ptr(), dW.data_ptr(),
        dL.data_ptr(), partials.data_ptr(), n1, n2, k_real, kp, P, blocks,
        int(n2 * W.element_size() % 16 == 0 and dW.data_ptr() % 16 == 0
            and dL.data_ptr() % 16 == 0),
        float(e0), float(early_termination), float(d1), float(d2),
        _kernels.stream_of(W),
    )
    sums = _kernels.sum_partials(partials)
    composite_bwd.launches += 1
    dtf = sums[:_NT].view(4, 256).T.contiguous()
    zero = sums.new_zeros(2)
    return dW, dL, dtf, torch.cat([sums[_NT:], zero])


composite_bwd.launches = 0
_WARPS = 8  # csrc/composite_bwd.cu: warps per block, one tile each


def _blocks(n1: int, n2: int) -> int:
    """K5's grid: a tile of ``composite.TILE`` pixels per warp, one row of
    partials per block."""
    th, tw = C.TILE
    tiles = -(-n1 // th) * -(-n2 // tw)
    return max(1, -(-tiles // _WARPS))


class _FusedComposite(torch.autograd.Function):
    """Forward `composite.composite` (K1, no jitter), backward
    :func:`composite_bwd` (K5), both looked up at call time."""

    @staticmethod
    def forward(ctx, W, L, tf_table, win, geo):
        ctx.geo = geo
        ctx.save_for_backward(W, L, tf_table, win, geo["e1"],
                              geo["step_world"])
        return C.composite(W, L, tf_table, geo["pa"], geo["occ"], geo["e1"],
                           geo["step_world"], None, win, geo["e0"],
                           geo["early_termination"], geo["d1"], geo["d2"],
                           geo["k_real"])

    @staticmethod
    def backward(ctx, g):
        W, L, tf_table, win, e1, step_world = ctx.saved_tensors
        geo = ctx.geo
        # one layout of g on both routes: the plain version's sums then run
        # in the same order whatever layout the caller's cotangent has
        with span(COMPOSITE_BWD):
            dW, dL, dtf, dwin = composite_bwd(
                W, L, tf_table, geo["pa"], e1, step_world, win,
                g.contiguous(), geo["e0"], geo["early_termination"],
                geo["d1"], geo["d2"], geo["k_real"])
        return dW, dL, dtf.to(tf_table.dtype), dwin, None


def fused_composite(W, L, tf_table, win, pa, occ, e1, step_world, e0: float,
                    early_termination: float, d1: int, d2: int,
                    k_real: int) -> torch.Tensor:
    """Differentiable lit composite of the pre-sheared planes -> (4, n1,
    n2); gradients flow to ``W``, ``L``, ``tf_table`` and ``win``."""
    geo = dict(pa=pa, occ=occ, e1=e1, step_world=step_world, e0=e0,
               early_termination=early_termination, d1=d1, d2=d2,
               k_real=k_real)
    return _FusedComposite.apply(W, L, tf_table, win, geo)


def shearwarp_intermediate_fused_diff(volume, tf_table, light_volume,
                                      plan: ShearWarpPlan, windowing_vec4,
                                      clip_center, clip_direction,
                                      early_termination: float = EARLY_TERMINATION_ALPHA,
                                      compute_dtype=None) -> torch.Tensor:
    """Differentiable lit shear-warp composite -> (4, n1, n2), the layout
    `warp.warp_to_screen_fused` reads (the JAX package's
    ``out_layout="chw"``). Gradients flow to ``volume``, ``tf_table``,
    ``windowing_vec4`` (center, width) and ``light_volume``."""
    ops = C.prepare_composite(volume, tf_table, light_volume, plan,
                              windowing_vec4, clip_center, clip_direction,
                              early_termination, compute_dtype)
    del ops["jitter"]
    return fused_composite(**ops)
