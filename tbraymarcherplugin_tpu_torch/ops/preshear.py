"""K12: the pre-shear of the shear-warp composite, and its adjoint.

The planes that K1 composites are the volume (and, in lit mode, the light
volume) resampled plane by plane onto the intermediate ray grid: plane k
lerps the source's slices ``m0[k]`` and ``m1[k]`` along the principal axis
by ``t[k]`` (or takes slice ``m0[k]`` alone) and samples that plane
bilinearly at rows ``clip(a1[k] + b1[k] i, 0, D1 - 1)`` and columns
``clip(a2[k] + b2[k] (j0 + j), 0, D2 - 1)``, or at the nearest texel
(the octree mode). :func:`preshear` launches `csrc/preshear.cu` for CUDA
tensors and runs :func:`preshear_plain` for CPU tensors; both compute in
float32 and round once to the plane type. The JAX package leaves this to
XLA as two banded einsums a plane (`shearwarp._resample_block`, which the
port keeps for its dense composite); the result is the same function, the
tent matrices' products without their zeros.

The per-plane numbers of one plan are packed into one float32 array a
stream (:class:`Stream`), uploaded once a plan and kept with the plan
(:func:`plan_streams`), so that a frame of a cached plan uploads nothing
for its pre-shear. Gradients flow to the source through
:class:`_Preshear`, whose backward is the adjoint kernel
(:func:`preshear_adjoint`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.profiling import PRESHEAR_BWD, span
from . import _kernels

COEF = 8  # floats a plane: a1, b1, a2, b2, t, m0, m1 (int32 bits), 0


@dataclasses.dataclass(frozen=True)
class Stream:
    """One stream's planes on a device: ``coef`` (K, 8) float32 rows a1,
    b1, a2, b2, t and the slices m0, m1 as int32 bits; ``slices`` (D0, 2)
    int32 [first, last + 1) of the planes that read each source slice (the
    adjoint's); ``m0``, ``m1`` the slices as int64 indices; ``ax`` the
    permutation of the source to (principal, rows, columns) and ``dims``
    its sizes there; ``lerp``: the planes lerp two slices; ``nearest``:
    the nearest texel instead of the bilinear taps."""

    coef: torch.Tensor
    slices: torch.Tensor
    m0: torch.Tensor
    m1: torch.Tensor
    ax: tuple
    dims: tuple
    n1: int
    n2: int
    j0: int
    lerp: bool
    nearest: bool

    @property
    def k(self) -> int:
        return self.coef.shape[0]


def _pad(x, n: int) -> np.ndarray:
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], n - len(x), 0)])


def _stream_arrays(plan, light: bool, kbuf: int, dims, nearest: bool):
    """(coef (K, 8), slices (D0, 2), lerp) of the volume's or the
    light volume's planes, ``dims`` the source's (D0, D1, D2); planes past
    the plan's repeat its last (the edge padding K1 reads)."""
    d0 = dims[0]
    if light:
        coeffs = (plan.la1, plan.lb1, plan.la2, plan.lb2)
        m0 = np.asarray(plan.lm0)
        m1 = np.minimum(m0 + 1, d0 - 1)
        t, lerp = plan.lmt, True
    else:
        coeffs = (plan.a1, plan.b1, plan.a2, plan.b2)
        m0, m1, t = plan.m_src, plan.msrc_hi, plan.mfrac
        lerp = t is not None
        if lerp and nearest:  # the nearest slice, as _volume_planes takes
            m0, lerp = np.where(plan.mfrac < 0.5, m0, m1), False
        if not lerp:
            m1, t = m0, np.zeros(len(m0), np.float32)
    coef = np.zeros((kbuf, COEF), np.float32)
    for c, x in enumerate(coeffs + (t,)):
        coef[:, c] = _pad(np.asarray(x, np.float32), kbuf)
    for c, m in ((5, m0), (6, m1)):
        coef[:, c] = _pad(np.asarray(m, np.int32), kbuf).view(np.float32)
    ks = np.full(d0, kbuf, np.int64)
    ke = np.zeros(d0, np.int64)
    k = np.arange(kbuf)
    for m in (coef[:, 5], coef[:, 6]) if lerp else (coef[:, 5],):
        m = m.view(np.int32)
        np.minimum.at(ks, m, k)
        np.maximum.at(ke, m, k + 1)
    ks = np.where(ke > 0, ks, 0)
    slices = np.stack([ks, ke], 1).astype(np.int32)
    return coef, slices, lerp


def plan_streams(plan, kbuf: int, vol_shape, light_shape, nearest: bool,
                 device):
    """(volume stream, light stream or None) of ``plan`` with ``kbuf``
    planes, for sources of ``vol_shape`` and ``light_shape`` (None: no
    light stream). Both streams' numbers go to ``device`` as one upload,
    kept with the plan (`ShearWarpPlan.memo`), so that the frames and steps
    of one plan upload them once."""
    ax = (plan.axis,) + tuple(plan.axes12)
    shapes = [tuple(int(vol_shape[a]) for a in ax)]
    if light_shape is not None:
        shapes.append(tuple(int(light_shape[a]) for a in ax))
    key = ("preshear", kbuf, tuple(shapes), bool(nearest), str(device))
    return plan.memo(key, lambda: _upload(plan, kbuf, shapes, nearest,
                                          device))


def _upload(plan, kbuf: int, shapes, nearest: bool, device):
    ax = (plan.axis,) + tuple(plan.axes12)
    parts = [_stream_arrays(plan, i == 1, kbuf, dims, nearest and i == 0)
             for i, dims in enumerate(shapes)]
    flat = np.concatenate([x.ravel().view(np.float32) for coef, slices, _
                           in parts for x in (coef, slices)])
    buf = to_device(flat, device)
    out, o = [], 0
    for (coef, slices, lerp), dims in zip(parts, shapes):
        c = buf[o:o + coef.size].view(coef.shape)
        o += coef.size
        s = buf[o:o + slices.size].view(torch.int32).view(slices.shape)
        o += slices.size
        m = c[:, 5:7].contiguous().view(torch.int32).long()
        out.append(Stream(c, s, m[:, 0], m[:, 1], ax, dims, plan.n1,
                          plan.n2, plan.j0, lerp, nearest and not out))
    return out[0], out[1] if len(out) > 1 else None


def _unpack(st: Stream):
    a1, b1, a2, b2, t = st.coef[:, :5].T
    return a1, b1, a2, b2, t


def _taps(a, b, x, dim: int, nearest: bool):
    """(i0, i1, w0, w1), each (K, n): the taps of the coordinates
    clip(a + b x, 0, dim - 1) of the K planes at the (n,) indices x."""
    v = (a[:, None] + b[:, None] * x[None, :]).clamp(0.0, float(dim - 1))
    if nearest:
        i = torch.floor(v + 0.5).long()
        return i, i, torch.ones_like(v), torch.zeros_like(v)
    f = torch.floor(v)
    fr = v - f
    i0 = f.long()
    return i0, (i0 + 1).clamp(max=dim - 1), 1.0 - fr, fr


def _grids(st: Stream, device):
    f32 = torch.float32
    return (torch.arange(st.n1, dtype=f32, device=device),
            torch.arange(st.j0, st.j0 + st.n2, dtype=f32, device=device))


def preshear_plain(src, st: Stream, dtype) -> torch.Tensor:
    """The (K, n1, n2) planes of ``st`` from the source volume ``src``,
    stored as ``dtype``; the kernel's arithmetic, one PyTorch operation per
    step in float32: the principal-axis lerp, the rows' taps, then the
    columns'."""
    s = src.permute(st.ax).to(torch.float32)
    _, D1, D2 = s.shape
    a1, b1, a2, b2, t = _unpack(st)
    ii, jj = _grids(st, s.device)
    P = s[st.m0]
    if st.lerp:
        tt = t[:, None, None]
        P = P * (1.0 - tt) + s[st.m1] * tt
    r0, r1, wr0, wr1 = _taps(a1, b1, ii, D1, st.nearest)
    line = (P.gather(1, r0[:, :, None].expand(-1, -1, D2)) * wr0[..., None]
            + P.gather(1, r1[:, :, None].expand(-1, -1, D2)) * wr1[..., None])
    c0, c1, wc0, wc1 = _taps(a2, b2, jj, D2, st.nearest)
    n1 = st.n1
    out = (line.gather(2, c0[:, None, :].expand(-1, n1, -1)) * wc0[:, None]
           + line.gather(2, c1[:, None, :].expand(-1, n1, -1)) * wc1[:, None])
    return out.to(dtype)


def preshear_adjoint_plain(g, st: Stream) -> torch.Tensor:
    """The source's cotangent, in the permuted (D0, D1, D2) layout, of
    :func:`preshear_plain` for the planes' cotangent ``g`` (K, n1, n2):
    the columns' taps, the rows' and the principal-axis lerp's transposed,
    as scatter-adds in float32."""
    f32 = torch.float32
    g = g.to(f32)
    D0, D1, D2 = st.dims
    K, n1, n2 = g.shape
    a1, b1, a2, b2, t = _unpack(st)
    ii, jj = _grids(st, g.device)
    c0, c1, wc0, wc1 = _taps(a2, b2, jj, D2, st.nearest)
    dline = torch.zeros((K, n1, D2), dtype=f32, device=g.device)
    for c, w in ((c0, wc0), (c1, wc1)):
        dline.scatter_add_(2, c[:, None, :].expand(-1, n1, -1),
                           g * w[:, None, :])
    r0, r1, wr0, wr1 = _taps(a1, b1, ii, D1, st.nearest)
    dP = torch.zeros((K, D1, D2), dtype=f32, device=g.device)
    for r, w in ((r0, wr0), (r1, wr1)):
        dP.scatter_add_(1, r[:, :, None].expand(-1, -1, D2),
                        dline * w[..., None])
    ds = torch.zeros((D0, D1, D2), dtype=f32, device=g.device)
    if st.lerp:
        tt = t[:, None, None]
        ds.index_add_(0, st.m0, dP * (1.0 - tt))
        ds.index_add_(0, st.m1, dP * tt)
    else:
        ds.index_add_(0, st.m0, dP)
    return ds


def _inverse(ax):
    return tuple(int(i) for i in np.argsort(ax))


def _forward(src, st: Stream, dtype) -> torch.Tensor:
    if src.device.type == "cpu":
        return preshear_plain(src, st, dtype)
    dev = src.device
    if src.dtype != torch.float32:
        raise ValueError(f"the pre-shear's source must be float32, got "
                         f"{src.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {dtype}")
    s = src.permute(st.ax)
    if tuple(s.shape) != st.dims or st.coef.device != dev:
        raise ValueError("the source differs from its stream's shape or "
                         "device")
    out = torch.empty((st.k, st.n1, st.n2), dtype=dtype, device=dev)
    name = "tbr_preshear_bf16" if dtype == torch.bfloat16 \
        else "tbr_preshear_f32"
    _kernels.launch(name, s.data_ptr(), *s.stride(), st.dims[1], st.dims[2],
                    st.coef.data_ptr(), out.data_ptr(), st.k, st.n1, st.n2,
                    st.j0, int(st.lerp), int(st.nearest),
                    _kernels.stream_of(src))
    preshear.launches += 1
    return out


def preshear_adjoint(g, st: Stream, shape) -> torch.Tensor:
    """The cotangent of a source of ``shape`` (its own layout, float32)
    from the planes' cotangent ``g`` (K, n1, n2); the CUDA route sums in a
    fixed order (the same bits on every run), the CPU route is
    :func:`preshear_adjoint_plain`. It gathers each texel's taps over a
    range of rows and columns, which needs b1, b2 >= 0: a plan's are
    λ times a grid spacing times a size (`shearwarp.plan_shearwarp`)."""
    if g.device.type == "cpu":
        return preshear_adjoint_plain(g, st).permute(_inverse(st.ax))
    dev = g.device
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the planes' cotangent must be float32 or "
                         f"bfloat16, got {g.dtype}")
    g = g.contiguous()
    if tuple(g.shape) != (st.k, st.n1, st.n2):
        raise ValueError(f"cotangent of shape {tuple(g.shape)}, planes "
                         f"{(st.k, st.n1, st.n2)}")
    D0, D1, D2 = st.dims
    ds = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    dline = torch.empty((st.k, st.n1, D2), dtype=torch.float32, device=dev)
    o = ds.permute(st.ax).stride()
    name = "tbr_preshear_adjoint_bf16" if g.dtype == torch.bfloat16 \
        else "tbr_preshear_adjoint_f32"
    _kernels.launch(name, g.data_ptr(), dline.data_ptr(), ds.data_ptr(), *o,
                    D0, D1, D2, st.coef.data_ptr(), st.slices.data_ptr(),
                    st.k, st.n1, st.n2, st.j0, int(st.lerp),
                    int(st.nearest), _kernels.stream_of(g))
    preshear_adjoint.launches += 1
    return ds


class _Preshear(torch.autograd.Function):
    """Forward :func:`_forward` (K12), backward :func:`preshear_adjoint`
    (its adjoint), run only where the source takes a gradient."""

    @staticmethod
    def forward(ctx, src, st, dtype):
        ctx.st, ctx.shape, ctx.src_dtype = st, tuple(src.shape), src.dtype
        return _forward(src, st, dtype)

    @staticmethod
    def backward(ctx, g):
        with span(PRESHEAR_BWD):
            ds = preshear_adjoint(g, ctx.st, ctx.shape)
        return ds.to(ctx.src_dtype), None, None


def preshear(src, st: Stream, dtype) -> torch.Tensor:
    """The (K, n1, n2) planes of ``st`` from ``src``, stored as ``dtype``:
    K12 for a CUDA tensor (float32 sources; it raises on what it does not
    take), :func:`preshear_plain` for a CPU one. Differentiable to ``src``.
    Counts each CUDA launch in ``preshear.launches``."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _Preshear.apply(src, st, dtype)
    return _forward(src, st, dtype)


preshear.launches = 0
preshear_adjoint.launches = 0


def slice_ranges(volume, axis: int):
    """(D0,) min and max of each slice of ``volume`` across ``axis``; plan
    data, which takes no gradient."""
    dims = tuple(d for d in range(3) if d != axis)
    v = volume.detach()
    return v.amin(dims), v.amax(dims)


def plane_value_ranges(ranges, st: Stream, k_real: int):
    """(K,) conservative (min, max) of the values of each of the first
    ``k_real`` planes of ``st`` (a volume stream) from ``ranges``, the
    source's :func:`slice_ranges` across the stream's principal axis: a
    plane samples one slice, or a lerp of two that lies between their
    ranges up to its rounding, which the range is widened by (2^-20 of its
    size)."""
    smn, smx = ranges
    mn, mx = smn[st.m0[:k_real]], smx[st.m0[:k_real]]
    if st.lerp:
        mn = torch.minimum(mn, smn[st.m1[:k_real]])
        mx = torch.maximum(mx, smx[st.m1[:k_real]])
        mn = mn - mn.abs() * 2.0 ** -20
        mx = mx + mx.abs() * 2.0 ** -20
    return mn, mx
