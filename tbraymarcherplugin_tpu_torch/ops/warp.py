"""K2 and K6: the two-pass screen warp of the shear-warp frame and its
adjoint.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_warp.py::
warp_to_screen_fused` (with ``channel_major=True``) and its differentiable
`banded_row_lerp`. :func:`row_lerp` launches `csrc/row_lerp.cu` and
:func:`row_lerp_bwd` launches `csrc/row_lerp_bwd.cu` for CUDA tensors; for
CPU tensors each runs its ``_plain`` version. Both passes of
:func:`warp_to_screen_fused` go through :func:`row_lerp_vjp`, so the warp
takes gradients to the intermediate image; the index fields take none.

The TPU kernels copied one fixed band of each source row into VMEM, so the
JAX package guards the per-tile index spread (`assert_warp_band`) and its
adjoint clips taps into the band. The Hopper kernels read and write their
taps in global or shared memory: they have no band and no guard, and agree
with the JAX package wherever its band holds the spread.
"""

from __future__ import annotations

import torch

from ..utils.profiling import WARP, WARP_BWD, span
from . import _kernels
from .shearwarp import ShearWarpPlan, screen_fields, warp_rows

# K6 takes rows of N texels whose 4 N floats fit a block's shared memory
# (a warp keeps one row's accumulators, a block 1 to 8 warps)
_MAX_BWD_SMEM = 227 * 1024


def _taps(idx: torch.Tensor, n: int):
    """(i0, i1, fr) of clamp-to-edge lerps into rows of ``n`` texels."""
    ic = idx.clamp(0.0, float(n - 1))
    i0f = torch.floor(ic)
    fr = ic - i0f
    i0 = i0f.long()
    return i0, (i0 + 1).clamp(max=n - 1), fr


def row_lerp_plain(rows: torch.Tensor, idx: torch.Tensor,
                   groups: int = 1) -> torch.Tensor:
    """``out[r, q] = lerp(rows[r], idx[r % Rq, q])`` with clamp-to-edge,
    ``rows`` (groups * Rq, N), ``idx`` (Rq, Q) -> (groups * Rq, Q)."""
    R, n = rows.shape
    Rq, Q = idx.shape
    i0, i1, fr = _taps(idx, n)
    rows3 = rows.view(groups, Rq, n)
    r0 = torch.gather(rows3, 2, i0[None].expand(groups, Rq, Q))
    r1 = torch.gather(rows3, 2, i1[None].expand(groups, Rq, Q))
    return (r0 + (r1 - r0) * fr).reshape(R, Q)


def row_lerp(rows: torch.Tensor, idx: torch.Tensor,
             groups: int = 1) -> torch.Tensor:
    """Per-row 1D lerp gather shared by ``groups`` channel blocks; see
    :func:`row_lerp_plain`."""
    R, n = rows.shape
    Rq, Q = idx.shape
    if R != Rq * groups:
        raise ValueError(f"rows {tuple(rows.shape)} != groups * {Rq} rows")
    if rows.device.type == "cpu":
        return row_lerp_plain(rows, idx, groups)
    rows = rows.contiguous()
    idx = idx.contiguous()
    _kernels.check(rows, "rows", torch.float32, rows.device)
    _kernels.check(idx, "idx", torch.float32, rows.device)
    out = torch.empty((R, Q), dtype=torch.float32, device=rows.device)
    _kernels.launch(
        "tbr_row_lerp", rows.data_ptr(), idx.data_ptr(), out.data_ptr(), R,
        Rq, n, Q, _kernels.stream_of(rows),
    )
    row_lerp.launches += 1
    return out


row_lerp.launches = 0


def row_lerp_bwd_plain(g: torch.Tensor, idx: torch.Tensor, n: int,
                       groups: int = 1) -> torch.Tensor:
    """Adjoint of :func:`row_lerp_plain` in ``rows``: ``g`` (groups * Rq,
    Q) -> d rows (groups * Rq, n), ``g * (1 - fr)`` added at tap i0 and
    ``g * fr`` at tap i1 of each (row, q)."""
    R, Q = g.shape
    i0, i1, fr = (t.repeat(groups, 1) for t in _taps(idx, n))
    d = torch.zeros((R, n), dtype=torch.float32, device=g.device)
    d.scatter_add_(1, i0, g * (1.0 - fr))
    d.scatter_add_(1, i1, g * fr)
    return d


def row_lerp_bwd(g: torch.Tensor, idx: torch.Tensor, n: int,
                 groups: int = 1) -> torch.Tensor:
    """d rows of :func:`row_lerp`; see :func:`row_lerp_bwd_plain`. Sums in a
    fixed order: the same bits on every run."""
    R, Q = g.shape
    Rq = idx.shape[0]
    if R != Rq * groups or idx.shape[1] != Q:
        raise ValueError(f"g {tuple(g.shape)} != groups * idx "
                         f"{tuple(idx.shape)}")
    if g.device.type == "cpu":
        return row_lerp_bwd_plain(g, idx, n, groups)
    g = g.contiguous()
    idx = idx.contiguous()
    _kernels.check(g, "g", torch.float32, g.device)
    _kernels.check(idx, "idx", torch.float32, g.device)
    if 4 * n * 4 > _MAX_BWD_SMEM:
        raise ValueError(f"row_lerp_bwd takes rows of at most "
                         f"{_MAX_BWD_SMEM // 16} texels, got {n}")
    d = torch.empty((R, n), dtype=torch.float32, device=g.device)
    _kernels.launch("tbr_row_lerp_bwd", g.data_ptr(), idx.data_ptr(),
                    d.data_ptr(), R, Rq, n, Q, _kernels.stream_of(g))
    row_lerp_bwd.launches += 1
    return d


row_lerp_bwd.launches = 0


class _RowLerp(torch.autograd.Function):
    """Forward :func:`row_lerp` (K2), backward :func:`row_lerp_bwd` (K6),
    both looked up at call time."""

    @staticmethod
    def forward(ctx, rows, idx, groups):
        ctx.n, ctx.groups = rows.shape[1], groups
        ctx.save_for_backward(idx)
        return row_lerp(rows, idx, groups)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        with span(WARP_BWD):
            return row_lerp_bwd(g, idx, ctx.n, ctx.groups), None, None


def row_lerp_vjp(rows: torch.Tensor, idx: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
    """Differentiable :func:`row_lerp` (gradient to ``rows`` only), the
    JAX package's ``banded_row_lerp``."""
    return _RowLerp.apply(rows, idx, groups)


def pass1_index(plan: ShearWarpPlan, W: int, p1r, p2r, pdr, device=None):
    """(n2, W) pass-1 index field i*(u, j), computed natively in (n2, W)
    orientation as the JAX package's fused warp does."""
    f32 = torch.float32
    o1, d1, o2, d2 = (float(x) for x in (plan.o1, plan.d1, plan.o2, plan.d2))
    pr1, pr2, prd = p1r.tolist(), p2r.tolist(), pdr.tolist()
    u = torch.arange(W, dtype=f32, device=device)[None, :]
    jj = torch.arange(plan.n2, dtype=f32, device=device)
    p2_of_j = (o2 + (jj + 0.5) * d2)[:, None]
    n2u = pr2[0] * u + pr2[2]
    dnu = prd[0] * u + prd[2]
    denv = pr2[1] - p2_of_j * prd[1]
    denv = torch.where(denv.abs() < 1e-12, torch.full_like(denv, 1e-12), denv)
    v_star = (p2_of_j * dnu - n2u) / denv
    den_s = prd[0] * u + prd[1] * v_star + prd[2]
    den_s = torch.where(den_s.abs() < 1e-12, torch.full_like(den_s, 1e-12),
                        den_s)
    p1_s = (pr1[0] * u + pr1[1] * v_star + pr1[2]) / den_s
    return (p1_s - o1) / d1 - 0.5


def warp_to_screen_fused(intermediate: torch.Tensor, plan: ShearWarpPlan,
                         width: int, height: int) -> torch.Tensor:
    """(4, n1, n2) channel-major intermediate image -> (height, width, 4)
    screen image via two :func:`row_lerp_vjp` passes and the validity
    mask."""
    with span(WARP):
        dev = intermediate.device
        p1r, p2r, pdr, W, H = warp_rows(plan, width, height)
        C = intermediate.shape[0]
        idx1 = pass1_index(plan, W, p1r, p2r, pdr, dev)  # (n2, W)
        rows1 = intermediate.transpose(1, 2).reshape(C * plan.n2, plan.n1)
        M = row_lerp_vjp(rows1, idx1, C).view(C, plan.n2, W)
        j_uv, valid = screen_fields(plan, W, H, p1r, p2r, pdr, dev)  # (W, H)
        rows2 = M.transpose(1, 2).reshape(C * W, plan.n2)
        S = row_lerp_vjp(rows2, j_uv, C).view(C, W, H)
        S = torch.where(valid[None], S, torch.zeros_like(S))
        img = S.permute(2, 1, 0)  # (H, W, C)
        if plan.swap_warp:
            img = img.permute(1, 0, 2)
        return img.contiguous()
