"""K10a and K10b: the windowed-TF RGBA unit of the dense shear-warp
composite and its backward.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_tf.py::windowed_tf_rgba`
(its ``_rgba_fwd_kernel`` and ``_rgba_bwd_kernel``), a drop-in for
`sampling.sample_windowed_transfer_function`. :func:`windowed_tf_rgba`
launches `csrc/tf_rgba.cu` and :func:`windowed_tf_rgba_bwd` launches
`csrc/tf_rgba_bwd.cu` for CUDA tensors; for CPU tensors each runs its
``_plain`` version. :func:`windowed_tf_rgba_vjp` is the differentiable
unit: gradients flow to the values, all four TF channels, the window's
center and width, and the step field. The window is read from a device
tensor, never through the host.
"""

from __future__ import annotations

import torch

from . import _kernels
from .tf_alpha import (_assemble, _clip_grad, _taps, _window,
                       histogram_stats)

# K10b (csrc/tf_rgba_bwd.cu): one block of 1024 threads per SM, each thread
# on runs of 4 elements; per block one row of partials (the 4 x 256
# histogram, d center, d width)
_BWD_PER_BLOCK = 1024 * 4
_BWD_ROW = 4 * 256 + 2


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    kernel's vector loads need that; a fresh allocation always does)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _step_field(step, values: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device=values.device)


def windowed_tf_rgba_plain(values: torch.Tensor, tf_table: torch.Tensor,
                           windowing_vec4, step) -> torch.Tensor:
    """(..., 4) RGBA per element of ``values``: the TF lerp of all four
    channels, alpha clamped and corrected for the ``step`` field
    (broadcastable to ``values``), zero where a cutoff applies; the
    kernel's arithmetic, one PyTorch operation per step."""
    step = _step_field(step, values)
    _, cut, _, i0, i1, frac = _taps(values, windowing_vec4)
    c0, c1 = tf_table[i0], tf_table[i1]
    c = c0 + (c1 - c0) * frac[..., None]
    alpha = c[..., 3].clamp(0.0, 1.0)
    alpha = 1.0 - torch.exp(step * torch.log(torch.clamp(1.0 - alpha,
                                                          min=1e-10)))
    rgba = torch.cat([c[..., :3], alpha[..., None]], dim=-1)
    return torch.where(cut[..., None], torch.zeros_like(rgba), rgba)


def _kernel_step(step: torch.Tensor, values: torch.Tensor):
    """The step as the kernels read it: ``step[i % len]`` over the flat
    values, so a field that broadcasts over leading axes (the dense
    composite's (n1, n2) step under (B, n1, n2) values) is not expanded."""
    shape = tuple(step.shape)
    while shape and shape[0] == 1:
        shape = shape[1:]
    if shape == tuple(values.shape[values.dim() - len(shape):]):
        return step.reshape(shape).contiguous()
    return step.expand(values.shape).contiguous()


def windowed_tf_rgba(values: torch.Tensor, tf_table: torch.Tensor,
                     windowing_vec4, step) -> torch.Tensor:
    """Windowed TF RGBA of every element of ``values`` (any shape) ->
    (..., 4), channel-last; ``step`` (already times VOLUME_DENSITY) is a
    number or a field broadcastable to ``values``."""
    if values.device.type == "cpu":
        return windowed_tf_rgba_plain(values, tf_table, windowing_vec4, step)
    dev = values.device
    values = values.contiguous()
    tf_table = tf_table.contiguous()
    win = _kernels.window_tensor(windowing_vec4, dev).contiguous()
    step = _kernel_step(_step_field(step, values), values)
    for name, t in (("values", values), ("tf_table", tf_table),
                    ("step", step)):
        _kernels.check(t, name, torch.float32, dev)
    if tuple(tf_table.shape) != (256, 4):
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    out = torch.empty(values.shape + (4,), dtype=torch.float32, device=dev)
    _kernels.launch(
        "tbr_tf_rgba", values.data_ptr(), tf_table.data_ptr(), win.data_ptr(),
        step.data_ptr(), out.data_ptr(), values.numel(), step.numel(),
        _kernels.stream_of(values),
    )
    windowed_tf_rgba.launches += 1
    return out


windowed_tf_rgba.launches = 0


def windowed_tf_rgba_bwd_plain(values, tf_table, windowing_vec4, step, g,
                               need_step: bool = True, stats=None):
    """Cotangents of :func:`windowed_tf_rgba` for the (..., 4) output
    cotangent ``g``: (d values, d TF (256, 4), d window (4,) = (d center,
    d width, 0, 0), d step over the full values field, or None without
    ``need_step``); the kernel's arithmetic, one PyTorch operation per step.
    The colour channels take ``g * keep``, alpha ``g * keep`` times the step
    correction's slope and XLA's clip subgradient (0.5 at an exact bound).
    A ``stats`` dict is filled with :func:`histogram_stats` of the
    histogram's floor texels (an element hits when any channel's cotangent
    is not zero)."""
    dev = values.device
    step = _step_field(step, values)
    _, width, _, _ = _window(windowing_vec4, dev)
    tf_pos, cut, x, i0, i1, frac = _taps(values, windowing_vec4)
    c0, c1 = tf_table[i0], tf_table[i1]
    a0, a1 = c0[..., 3], c1[..., 3]
    a_raw = a0 + (a1 - a0) * frac
    one_m = 1.0 - a_raw.clamp(0.0, 1.0)
    logb = torch.log(torch.clamp(one_m, min=1e-10))
    basemask = (one_m >= 1e-10).to(values.dtype)
    dcorr = step * torch.exp((step - 1.0) * logb) * basemask
    keep = (~cut).to(values.dtype)
    geff = [g[..., c] * keep for c in range(3)]
    geff.append(g[..., 3] * keep * dcorr * _clip_grad(a_raw))
    gx = geff[0] * (c1[..., 0] - c0[..., 0])
    for c in range(1, 4):
        gx = gx + geff[c] * (c1[..., c] - c0[..., c])
    dval = gx * (256.0 / width)
    dc = (gx * (-256.0 / width)).sum()
    dw = (gx * (256.0 * (0.5 - tf_pos) / width)).sum()
    dstep = None
    if need_step:
        dstep = g[..., 3] * keep * -torch.exp(step * logb) * logb
    in_rng = (x >= 0.0) & (x < 255.0)
    w_lo = torch.where(in_rng, 1.0 - frac, torch.ones_like(frac)).flatten()
    w_hi = torch.where(in_rng, frac, torch.zeros_like(frac)).flatten()
    idx = i0.flatten()
    h = torch.zeros((2, 4, 256), dtype=torch.float32, device=dev)
    for c in range(4):
        gc = geff[c].flatten()
        h[0, c].index_add_(0, idx, gc * w_lo)
        h[1, c].index_add_(0, idx, gc * w_hi)
    dtf = _assemble(h[0], h[1]).T.contiguous()
    if stats is not None:
        hit = torch.stack([gc != 0.0 for gc in geff]).any(dim=0)
        stats.update(histogram_stats(i0, hit))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return dval, dtf, torch.stack([dc, dw, zero, zero]), dstep


def windowed_tf_rgba_bwd(values, tf_table, windowing_vec4, step, g,
                         need_step: bool = True):
    """Cotangents of :func:`windowed_tf_rgba`; see
    :func:`windowed_tf_rgba_bwd_plain`. The histogram and the window sums
    reduce in a fixed order: the same bits on every run."""
    if values.device.type == "cpu":
        return windowed_tf_rgba_bwd_plain(values, tf_table, windowing_vec4,
                                          step, g, need_step)
    dev = values.device
    values = _aligned(values.contiguous())
    g = _aligned(g.contiguous())
    tf_table = tf_table.contiguous()
    win = _kernels.window_tensor(windowing_vec4, dev).contiguous()
    step = _aligned(_kernel_step(_step_field(step, values), values))
    for name, t in (("values", values), ("g", g), ("tf_table", tf_table),
                    ("step", step)):
        _kernels.check(t, name, torch.float32, dev)
    if tuple(tf_table.shape) != (256, 4) or g.shape != values.shape + (4,):
        raise ValueError("tf_table must be (256, 4) and g shaped (*values, 4)")
    n = values.numel()
    blocks = max(1, min(-(-n // _BWD_PER_BLOCK), _kernels.sm_count(dev)))
    dval = torch.empty_like(values)
    dstep = torch.empty_like(values) if need_step else None
    partials = torch.empty((blocks, _BWD_ROW), dtype=torch.float32,
                           device=dev)
    dtf = torch.empty((256, 4), dtype=torch.float32, device=dev)
    dwin = torch.empty(4, dtype=torch.float32, device=dev)
    stream = _kernels.stream_of(values)
    _kernels.launch(
        "tbr_tf_rgba_bwd", values.data_ptr(), tf_table.data_ptr(),
        win.data_ptr(), step.data_ptr(), g.data_ptr(), dval.data_ptr(),
        dstep.data_ptr() if need_step else None, partials.data_ptr(),
        _kernels.done_counter(dev, stream).data_ptr(), dtf.data_ptr(),
        dwin.data_ptr(), n, step.numel(), blocks, stream,
    )
    windowed_tf_rgba_bwd.launches += 1
    return dval, dtf, dwin, dstep


windowed_tf_rgba_bwd.launches = 0


class _WindowedTFRGBA(torch.autograd.Function):
    """Forward :func:`windowed_tf_rgba` (K10a), backward
    :func:`windowed_tf_rgba_bwd` (K10b), both looked up at call time."""

    @staticmethod
    def forward(ctx, values, tf_table, win, step):
        ctx.save_for_backward(values, tf_table, win, step)
        return windowed_tf_rgba(values, tf_table, win, step)

    @staticmethod
    def backward(ctx, g):
        values, tf_table, win, step = ctx.saved_tensors
        need_step = ctx.needs_input_grad[3]
        dval, dtf, dwin, dstep = windowed_tf_rgba_bwd(
            values, tf_table, win, step, g, need_step)
        if need_step:  # reduce over the axes the step was broadcast along
            dstep = dstep.sum_to_size(step.shape)
        return dval, dtf.to(tf_table.dtype), dwin, dstep


def windowed_tf_rgba_vjp(values: torch.Tensor, tf_table: torch.Tensor,
                         windowing_vec4, step) -> torch.Tensor:
    """Differentiable :func:`windowed_tf_rgba` (the JAX package's
    ``windowed_tf_rgba`` with its custom VJP): gradients to ``values``,
    ``tf_table``, the window (center, width) and ``step``, a field
    broadcastable to ``values`` whose cotangent sums over the broadcast
    axes."""
    win = _kernels.window_tensor(windowing_vec4, values.device)
    return _WindowedTFRGBA.apply(values, tf_table, win,
                                 _step_field(step, values))
