"""K4 and K7: the illumination propagation scan of one cube face and its
adjoint.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_lighting.py::
propagate_face_scan` (forward and custom VJP). For CUDA tensors
:func:`propagate_face_scan` launches `csrc/light_scan.cu` and
:func:`propagate_face_scan_bwd` launches `csrc/light_scan_bwd.cu`, each one
cooperative launch per face whose blocks hand off to their neighbours
through counters kept per device and stream (:func:`_scan_flags`; K4 hands
off once every few slices, as :func:`scan_plan` decides); for CPU tensors
each runs its ``_plain`` version.
:func:`propagate_face_scan_vjp` is the differentiable scan: gradients flow
to the opacities and to ``light_alpha`` (intensity times face weight),
which the kernels read from device memory; the offsets are geometry and
take none.
"""

from __future__ import annotations

from typing import NamedTuple

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


# K4's groups: at most SCAN_SLICES slices between hand-offs, and a halo of
# at most SCAN_HALO_ROWS rows (slices times reach) a group
SCAN_SLICES = 8
SCAN_HALO_ROWS = 8
# units a thread placed once (and whose o is loaded ahead), by unit width
_MAX_PLACED = {1: 4, 4: 2}


class ScanPlan(NamedTuple):
    """K4's launch for one face (`csrc/light_scan.cu`)."""

    blocks: int      # one per SM at most; block b owns rows [b rows, ...)
    rows: int
    slices: int      # T: slices between hand-offs
    reach: int       # rows beyond a row that its taps read, on one side
    up: bool         # that side: above (off_x < 0) or below
    staged: bool     # the band and a halo of slices * reach rows in smem
    threads: int     # a block's, sized to the frame (its first slice)
    vec: int         # V: adjacent pixels a unit (4 where W allows)
    per_thread: int  # P: units a thread placed once, o loaded ahead
    chunks: int      # chunks of P units a thread
    smem: int        # bytes of shared memory

    @property
    def halo(self) -> int:
        """Rows of the previous slice a group reads beyond the band."""
        return self.slices * self.reach

    def groups(self, k: int) -> int:
        """Hand-off steps of a scan of ``k`` slices."""
        return -(-k // self.slices)


def scan_plan(k: int, h: int, w: int, off_px, sms: int, smem_limit: int,
              slices=None, staged=None, vec=None) -> ScanPlan:
    """K4's launch for a (k, h, w) face with row offset ``off_px`` on a
    card of ``sms`` SMs and ``smem_limit`` bytes of shared memory a block.
    Blocks split the rows as evenly as one block per SM allows. T (the
    slices between hand-offs) is the largest power of two up to
    SCAN_SLICES and ``k`` whose halo stays within SCAN_HALO_ROWS and whose
    two stage buffers fit; a face whose band and one-slice halo do not fit
    shared memory runs unstaged (T = 1, taps from L2). A thread takes units
    of 4 adjacent pixels where ``w`` is a multiple of 4, else of 1, and the
    block is sized to the units of a group's first slice. ``vec`` is 1 for
    a face not 16-byte aligned; ``slices``, ``staged`` and ``vec`` force a
    plan (the card tests and `tools/sweep_scans.py`, which launch it with
    :func:`_launch_scan`)."""
    ix, _ = _split_offset(off_px)
    up = ix < 0
    reach = -ix if up else ix + 1
    blocks = max(min(h, sms), 1)
    rows = -(-h // blocks)
    blocks = -(-h // rows)

    def stage_bytes(t):  # one buffer, or two in turn
        return (1 if t == 1 else 2) * (rows + t * reach) * w * 4

    if slices is None:
        slices = 1
        while (slices * 2 <= min(SCAN_SLICES, max(k, 1))
               and slices * 2 * reach <= SCAN_HALO_ROWS
               and stage_bytes(slices * 2) <= smem_limit):
            slices *= 2
    if staged is None:
        staged = stage_bytes(slices) <= smem_limit
    if not staged and slices != 1:
        raise ValueError("an unstaged K4 hands off every slice")
    if staged and stage_bytes(slices) > smem_limit:
        raise ValueError(f"K4's stage of {stage_bytes(slices)} bytes "
                         f"exceeds {smem_limit}")
    if vec is None:
        vec = 4 if w % 4 == 0 else 1
    if vec not in _MAX_PLACED or w % vec:
        raise ValueError(f"K4 takes units of 4 or 1 pixels dividing {w}, "
                         f"got {vec}")
    units = (rows + (slices - 1) * reach) * (w // vec)
    most = _MAX_PLACED[vec]
    per_thread = next((p for p in range(1, most + 1)
                       if -(-units // p) <= 1024), most)
    threads = min(-(-units // per_thread // 32) * 32, 1024) or 32
    return ScanPlan(blocks, rows, slices, reach, up, staged, threads, vec,
                    per_thread, -(-units // (per_thread * threads)),
                    stage_bytes(slices) if staged else 0)


# cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin
_ATTR_SMS, _ATTR_SMEM_OPTIN = 16, 97
_LIMITS: dict = {}


def device_limits(dev) -> tuple[int, int]:
    """(SMs, shared memory bytes a block may opt in to) of CUDA ``dev``."""
    lim = _LIMITS.get(dev.index)
    if lim is None:
        with torch.cuda.device(dev):
            lim = tuple(_kernels.query("tbr_device_attribute", a)
                        for a in (_ATTR_SMS, _ATTR_SMEM_OPTIN))
        if min(lim) <= 0:
            raise RuntimeError(f"device attributes of {dev}: {lim}")
        _LIMITS[dev.index] = lim
    return lim


# K4's and K7's blocks wait for their neighbours through counters that
# persist between calls: (device, stream) -> [int64 counters, the value they
# reached]; one monotone base orders both kernels' launches on a stream
_SCAN_FLAGS: dict = {}
_SCAN_FLAG_COUNT = 1024  # at least the blocks of a launch: one per SM


def _scan_flags(dev, stream: int, steps: int):
    """The counters of K4's and K7's launches on ``stream`` and the base of
    the next launch of ``steps`` hand-off steps (see `csrc/scan_sync.cuh`);
    zero-filled once per device and stream."""
    key = (dev.index, stream)
    state = _SCAN_FLAGS.get(key)
    if state is None:
        state = _SCAN_FLAGS[key] = [
            torch.zeros(_SCAN_FLAG_COUNT, dtype=torch.int64, device=dev), 0]
    base = state[1]
    state[1] += steps
    return state[0], base


def propagate_face_scan(opacity_scan: torch.Tensor, off_px, off_py,
                        light_alpha) -> torch.Tensor:
    """Propagation scan of one face; see :func:`propagate_face_scan_plain`.
    ``light_alpha`` is a number or a 0-d tensor. On the card, one
    cooperative launch of K4 in the shape :func:`scan_plan` gives."""
    if opacity_scan.device.type == "cpu":
        return propagate_face_scan_plain(opacity_scan, off_px, off_py,
                                         light_alpha)
    op = opacity_scan.contiguous()
    _kernels.check(op, "opacity_scan", torch.float32, op.device)
    K, H, W = op.shape
    if K == 0 or H == 0 or W == 0:
        return torch.empty_like(op)
    plan = scan_plan(K, H, W, off_px, *device_limits(op.device),
                     vec=1 if op.data_ptr() % 16 else None)
    return _launch_scan(op, plan, off_px, off_py, light_alpha)


def _launch_scan(op: torch.Tensor, plan: ScanPlan, off_px, off_py,
                 light_alpha) -> torch.Tensor:
    """One launch of K4 on the contiguous float32 CUDA face ``op`` in the
    shape of ``plan``, a :func:`scan_plan` of its shape."""
    dev = op.device
    K, H, W = op.shape
    if plan.vec == 4 and op.data_ptr() % 16:
        raise ValueError("K4's units of 4 pixels need a 16-byte aligned face")
    if plan.blocks > _SCAN_FLAG_COUNT:
        raise ValueError(f"K4: {plan.blocks} blocks exceed the counters")
    if isinstance(light_alpha, torch.Tensor):
        alpha = _alpha_tensor(light_alpha, dev).contiguous()
        alpha_p, alpha_v = alpha.data_ptr(), 0.0
    else:  # by value: no fill on the device
        alpha_p, alpha_v = None, float(np.float32(light_alpha))
    out = torch.empty_like(op)
    ix, fx = _split_offset(off_px)
    iy, fy = _split_offset(off_py)
    stream = _kernels.stream_of(op)
    flags, base = _scan_flags(dev, stream, plan.groups(K))
    _kernels.launch(
        "tbr_light_scan", op.data_ptr(), out.data_ptr(), flags.data_ptr(),
        base, K, H, W, plan.blocks, plan.rows, plan.slices, plan.reach,
        int(plan.staged), plan.threads, plan.per_thread, plan.vec,
        plan.chunks, plan.smem, ix, float(fx), iy, float(fy), alpha_p,
        alpha_v, stream,
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
    if blocks == 0 or blocks > _SCAN_FLAG_COUNT:
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
    flags, base = _scan_flags(dev, stream, K)
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
