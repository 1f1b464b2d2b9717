"""K4 and K7: the illumination propagation scan of one cube face and its
adjoint.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_lighting.py::
propagate_face_scan` (forward and custom VJP). :func:`propagate_face_scan`
launches `csrc/light_scan.cu` (one launch per slice, issued by a host loop
in C) and :func:`propagate_face_scan_bwd` launches `csrc/light_scan_bwd.cu`
(one launch per face) for CUDA tensors; for CPU tensors each runs its
``_plain`` version.
:func:`propagate_face_scan_vjp` is the differentiable scan: gradients flow
to the opacities and to ``light_alpha`` (intensity times face weight),
which the kernels read from device memory; the offsets are geometry and
take none.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels


def _split_offset(off):
    """float32 offset -> (integer part, float32 fraction), as the JAX
    package's float32 arithmetic gives them."""
    off = np.float32(off)
    i0 = np.floor(off)
    return int(i0), np.float32(off - i0)


def _shift_1d_border(arr: torch.Tensor, offset, dim: int, border):
    """Linear resample of ``arr`` shifted by a constant fractional
    ``offset`` along ``dim``; taps outside the array read ``border`` (a
    number or a 0-d tensor)."""
    n = arr.shape[dim]
    i0, frac = _split_offset(offset)
    pad_shape = list(arr.shape)
    pad_shape[dim] = n
    pad = torch.as_tensor(border, dtype=arr.dtype,
                          device=arr.device).expand(pad_shape)
    padded = torch.cat([pad, arr, pad], dim=dim)

    def tap(d):
        start = min(max(i0 + n + d, 0), 2 * n)
        return padded.narrow(dim, start, n)

    return tap(0) * float(np.float32(1.0) - frac) + tap(1) * float(frac)


def shift_2d_bilinear_border(buffer: torch.Tensor, offset_x, offset_y,
                             border) -> torch.Tensor:
    """Bilinear resample of a 2D buffer at ``pixel + (offset_x, offset_y)``
    with a constant border (`AddDirLightShader.usf:80-82`)."""
    out = _shift_1d_border(buffer, offset_x, 0, border)
    return _shift_1d_border(out, offset_y, 1, border)


def _alpha_tensor(light_alpha, device) -> torch.Tensor:
    """``light_alpha`` as a 0-d float32 tensor on ``device`` (a tensor
    already there is used as it is)."""
    if isinstance(light_alpha, torch.Tensor):
        return light_alpha.to(device=device, dtype=torch.float32).reshape(())
    # a fill on the device: no host-to-device copy, so no sync
    return torch.full((), float(np.float32(light_alpha)), dtype=torch.float32,
                      device=device)


def propagate_face_scan_plain(opacity_scan: torch.Tensor, off_px, off_py,
                              light_alpha) -> torch.Tensor:
    """(K, H, W) scan-ordered occluder opacities -> every transmitted slice
    ``c_k = shift2d_border(c_{k-1}, off, alpha) * (1 - o_k)``,
    ``c_{-1} = alpha``."""
    alpha = _alpha_tensor(light_alpha, opacity_scan.device)
    carry = alpha.expand(opacity_scan.shape[1:])
    out = torch.empty_like(opacity_scan)
    for k in range(opacity_scan.shape[0]):
        prev = shift_2d_bilinear_border(carry, off_px, off_py, alpha)
        carry = prev * (1.0 - opacity_scan[k])
        out[k] = carry
    return out


def propagate_face_scan(opacity_scan: torch.Tensor, off_px, off_py,
                        light_alpha) -> torch.Tensor:
    """Propagation scan of one face; see :func:`propagate_face_scan_plain`.
    ``light_alpha`` is a number or a 0-d tensor."""
    if opacity_scan.device.type == "cpu":
        return propagate_face_scan_plain(opacity_scan, off_px, off_py,
                                         light_alpha)
    op = opacity_scan.contiguous()
    _kernels.check(op, "opacity_scan", torch.float32, op.device)
    alpha = _alpha_tensor(light_alpha, op.device).contiguous()
    K, H, W = op.shape
    ix, fx = _split_offset(off_px)
    iy, fy = _split_offset(off_py)
    out = torch.empty_like(op)
    _kernels.launch(
        "tbr_light_scan", op.data_ptr(), out.data_ptr(), K, H, W, ix,
        float(fx), iy, float(fy), alpha.data_ptr(), _kernels.stream_of(op),
    )
    propagate_face_scan.launches += 1
    return out


propagate_face_scan.launches = 0


def propagate_face_scan_bwd_plain(g, opacity_scan, y, off_px, off_py,
                                  light_alpha):
    """Reverse shift-scan of the scan's output cotangent ``g``, with ``y``
    the forward output: (d opacities, sum_k m_k, m_0) where, for k from K-1
    down to 0, ``lam_k = g_k + shift2d_border(m_{k+1}, -off, 0)``,
    ``m_k = (1 - o_k) lam_k`` and ``d o_k = -shift2d_border(y_{k-1}, off,
    alpha) lam_k`` (``m_K = 0``, ``y_{-1} = alpha``)."""
    alpha = _alpha_tensor(light_alpha, opacity_scan.device)
    K = opacity_scan.shape[0]
    m = torch.zeros_like(opacity_scan[0])
    msum = torch.zeros_like(m)
    d_op = torch.empty_like(opacity_scan)
    neg_x, neg_y = -np.float32(off_px), -np.float32(off_py)
    for k in range(K - 1, -1, -1):
        lam = g[k] + shift_2d_bilinear_border(m, neg_x, neg_y, 0.0)
        prev = y[k - 1] if k > 0 else alpha.expand(m.shape)
        pre = shift_2d_bilinear_border(prev, off_px, off_py, alpha)
        d_op[k] = -pre * lam
        m = (1.0 - opacity_scan[k]) * lam
        msum = msum + m
    return d_op, msum, m


# K7's blocks wait for their neighbours through counters that persist
# between calls: (device, stream) -> [int64 counters, the value they reached]
_BWD_FLAGS: dict = {}
_BWD_FLAG_COUNT = 1024  # at least the blocks of a launch: one per SM


def _bwd_flags(dev, stream: int, steps: int):
    """The counters of K7's launches on ``stream`` and the base of the next
    launch of ``steps`` slices (see `csrc/light_scan_bwd.cu`); zero-filled
    once per device and stream."""
    key = (dev.index, stream)
    state = _BWD_FLAGS.get(key)
    if state is None:
        state = _BWD_FLAGS[key] = [
            torch.zeros(_BWD_FLAG_COUNT, dtype=torch.int64, device=dev), 0]
    base = state[1]
    state[1] += steps
    return state[0], base


def propagate_face_scan_bwd(g, opacity_scan, y, off_px, off_py, light_alpha):
    """Adjoint of :func:`propagate_face_scan`; see
    :func:`propagate_face_scan_bwd_plain`. On the card, one launch of K7
    per face, up to 1024x1024 on an H100; a larger face raises."""
    if opacity_scan.device.type == "cpu":
        return propagate_face_scan_bwd_plain(g, opacity_scan, y, off_px,
                                             off_py, light_alpha)
    dev = opacity_scan.device
    op, g, y = (t.contiguous() for t in (opacity_scan, g, y))
    for name, t in (("opacity_scan", op), ("g", g), ("y", y)):
        _kernels.check(t, name, torch.float32, dev)
    if g.shape != op.shape or y.shape != op.shape:
        raise ValueError("g, y and the opacities differ in shape")
    K, H, W = op.shape
    with torch.cuda.device(dev):
        blocks = _kernels.query("tbr_light_scan_bwd_blocks", H, W)
    if blocks == 0 or blocks > _BWD_FLAG_COUNT:
        raise ValueError(
            f"propagate_face_scan_bwd (kernel K7): a {H}x{W} face is too "
            f"large for one launch of at most one block per SM, 8 pixels a "
            f"thread (see csrc/light_scan_bwd.cu)")
    alpha = _alpha_tensor(light_alpha, dev).contiguous()
    ix, fx = _split_offset(off_px)
    iy, fy = _split_offset(off_py)
    jx, hx = _split_offset(-np.float32(off_px))
    jy, hy = _split_offset(-np.float32(off_py))
    d_op = torch.empty_like(op)
    msum = torch.empty((H, W), dtype=torch.float32, device=dev)
    m0 = torch.empty((H, W), dtype=torch.float32, device=dev)
    mbuf = torch.empty((2, H, W), dtype=torch.float32, device=dev)
    stream = _kernels.stream_of(op)
    flags, base = _bwd_flags(dev, stream, K)
    _kernels.launch(
        "tbr_light_scan_bwd", g.data_ptr(), op.data_ptr(), y.data_ptr(),
        d_op.data_ptr(), msum.data_ptr(), m0.data_ptr(), mbuf.data_ptr(),
        flags.data_ptr(), base, K, H, W, ix, float(fx), iy, float(fy), jx,
        float(hx), jy, float(hy), alpha.data_ptr(), stream,
    )
    propagate_face_scan_bwd.launches += 1
    return d_op, msum, m0


propagate_face_scan_bwd.launches = 0


class _PropagateFaceScan(torch.autograd.Function):
    """Forward :func:`propagate_face_scan` (K4), backward
    :func:`propagate_face_scan_bwd` (K7) plus the d alpha assembly of
    `pallas_lighting._propagate_scan_bwd`, all looked up at call time."""

    @staticmethod
    def forward(ctx, opacity_scan, alpha, off_px, off_py):
        y = propagate_face_scan(opacity_scan, off_px, off_py, alpha)
        ctx.offsets = (off_px, off_py)
        ctx.save_for_backward(opacity_scan, y, alpha)
        return y

    @staticmethod
    def backward(ctx, g):
        op, y, alpha = ctx.saved_tensors
        off_px, off_py = ctx.offsets
        d_op, msum, m0 = propagate_face_scan_bwd(g, op, y, off_px, off_py,
                                                 alpha)
        plane = op[0]
        border_field = shift_2d_bilinear_border(torch.zeros_like(plane),
                                                off_px, off_py, 1.0)
        a_ones = shift_2d_bilinear_border(torch.ones_like(plane), off_px,
                                          off_py, 0.0)
        dalpha = (msum * border_field).sum() + (m0 * a_ones).sum()
        return d_op, dalpha.reshape(alpha.shape), None, None


def propagate_face_scan_vjp(opacity_scan: torch.Tensor, off_px, off_py,
                            light_alpha) -> torch.Tensor:
    """Differentiable :func:`propagate_face_scan` (the JAX package's
    ``pallas_lighting.propagate_face_scan``): gradients flow to the
    opacities and to ``light_alpha`` (a number or a 0-d tensor)."""
    alpha = _alpha_tensor(light_alpha, opacity_scan.device)
    return _PropagateFaceScan.apply(opacity_scan, alpha, np.float32(off_px),
                                    np.float32(off_py))
