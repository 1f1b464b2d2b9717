"""K3 and K8: elementwise windowed-TF alpha (the occluder field of light
propagation) and its backward.

Counterpart of `tbraymarcherplugin_tpu/ops/pallas_tf.py::windowed_tf_alpha`
and `windowed_tf_alpha_vjp`. :func:`windowed_tf_alpha` launches
`csrc/tf_alpha.cu` and :func:`windowed_tf_alpha_bwd` launches
`csrc/tf_alpha_bwd.cu` for CUDA tensors; for CPU tensors each runs its
``_plain`` version. :func:`windowed_tf_alpha_vjp` is the differentiable
unit: gradients flow to the values, the TF table's alpha column and the
window's center and width. The window is read from a device tensor, never
through the host.
"""

from __future__ import annotations

import torch

from ..utils.profiling import TF_ALPHA_BWD, span
from . import _kernels

# K8 (csrc/tf_alpha_bwd.cu): at most one block of 1024 threads per SM, each
# thread on runs of 4 elements; per block one row of partials (the alpha
# column's 256 texels, d center, d width)
_BWD_PER_BLOCK = 1024 * 4
_BWD_ROW = 256 + 2


def _window(windowing_vec4, device):
    win = _kernels.window_tensor(windowing_vec4, device)
    return win[0], win[1], win[2], win[3]


def _taps(values, windowing_vec4):
    """(tf_pos, cut, x, i0, i1, frac) of the windowed, clamp-addressed
    256-texel lookup, one PyTorch operation per step (the kernels'
    `tbr_tf_pos`, `tbr_cut` and `tbr_tf_taps`)."""
    center, width, low_c, high_c = _window(windowing_vec4, values.device)
    tf_pos = (values - center + width * 0.5) / width
    cut = ((tf_pos < 0.0) & (low_c > 0.0)) | ((tf_pos > 1.0) & (high_c > 0.0))
    x = tf_pos * 256.0 - 0.5
    i0f = torch.floor(x)
    frac = x - i0f
    i0 = i0f.clamp(0.0, 255.0).long()
    i1 = (i0f + 1.0).clamp(0.0, 255.0).long()
    return tf_pos, cut, x, i0, i1, frac


def windowed_tf_alpha_plain(values: torch.Tensor, tf_table: torch.Tensor,
                            windowing_vec4, step_size: float) -> torch.Tensor:
    """Step-corrected windowed TF alpha per element: the kernel's arithmetic,
    one PyTorch operation per step."""
    _, cut, _, i0, i1, frac = _taps(values, windowing_vec4)
    table = tf_table[:, 3]
    a0, a1 = table[i0], table[i1]
    alpha = (a0 + (a1 - a0) * frac).clamp(0.0, 1.0)
    base = torch.clamp(1.0 - alpha, min=1e-10)
    alpha = 1.0 - torch.exp(float(step_size) * torch.log(base))
    return torch.where(cut, torch.zeros_like(alpha), alpha)


def windowed_tf_alpha(values: torch.Tensor, tf_table: torch.Tensor,
                      windowing_vec4, step_size: float) -> torch.Tensor:
    """Windowed TF alpha of every element of ``values`` (any shape) with a
    scalar ``step_size`` (already times VOLUME_DENSITY)."""
    if values.device.type == "cpu":
        return windowed_tf_alpha_plain(values, tf_table, windowing_vec4,
                                       step_size)
    dev = values.device
    values = values.contiguous()
    tf_table = tf_table.contiguous()
    win = _kernels.window_tensor(windowing_vec4, dev).contiguous()
    _kernels.check(values, "values", torch.float32, dev)
    _kernels.check(tf_table, "tf_table", torch.float32, dev)
    if tuple(tf_table.shape) != (256, 4):
        raise ValueError(f"tf_table must be (256, 4), got {tf_table.shape}")
    out = torch.empty_like(values)
    _kernels.launch(
        "tbr_tf_alpha", values.data_ptr(), tf_table.data_ptr(),
        win.data_ptr(), out.data_ptr(), values.numel(), float(step_size),
        _kernels.stream_of(values),
    )
    windowed_tf_alpha.launches += 1
    return out


windowed_tf_alpha.launches = 0


def _clip_grad(a):
    """XLA's subgradient of clip(a, 0, 1): 0.5 at an exact bound."""
    inside = ((a > 0.0) & (a < 1.0)).to(a.dtype)
    tie = ((a == 0.0) | (a == 1.0)).to(a.dtype)
    return inside + 0.5 * tie


def _assemble(h0, h1):
    """Histogram of the floor tap plus the frac tap's, which was kept at the
    floor texel and belongs one texel higher; the last axis is texels."""
    return h0 + torch.nn.functional.pad(h1[..., :-1], (1, 0))


def warp_rounds(i0: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Per warp of 32 consecutive flat elements (the last one padded), the
    largest number of hitting elements on one texel of ``i0`` (0 for a
    warp with no hit): the one-at-a-time add rounds of a warp whose lanes
    take one element each."""
    n = i0.numel()
    pad = -n % 32
    lane = torch.arange(n + pad, device=i0.device)
    # a miss gets a key of its own (below every texel), so it groups with
    # nothing
    key = torch.cat([torch.where(hit, i0, -1 - lane[:n] % 32),
                     -1 - lane[n:] % 32]).view(-1, 32)
    s = torch.sort(key, dim=1).values
    pos = torch.arange(32, device=i0.device).expand_as(s)
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                         dim=1).values
    group = torch.where(s >= 0, pos - first + 1, torch.zeros_like(pos))
    return group.amax(dim=1)


def histogram_stats(i0: torch.Tensor, hit: torch.Tensor) -> dict:
    """How the histogram adds of the flat texels ``i0`` (only where ``hit``)
    cluster: ``hit``, the share of elements that add; ``rounds_mean`` and
    ``rounds_max`` of :func:`warp_rounds`; ``run_mean``, the mean length of
    the runs of equal ``i0`` along the elements."""
    i0, hit = i0.flatten(), hit.flatten()
    n = i0.numel()
    rounds = warp_rounds(i0, hit) if n else None
    runs = 1 + int((i0[1:] != i0[:-1]).sum()) if n else 0
    return dict(hit=float(hit.float().mean()) if n else 0.0,
                rounds_mean=float(rounds.float().mean()) if n else 0.0,
                rounds_max=int(rounds.max()) if n else 0,
                run_mean=n / runs if n else 0.0)


def windowed_tf_alpha_bwd_plain(values, tf_table, windowing_vec4,
                                step_size: float, g, stats=None):
    """Cotangents of :func:`windowed_tf_alpha` for the output cotangent
    ``g``: (d values, d TF (256, 4) with zeros in RGB, d window (4,) =
    (d center, d width, 0, 0)); the kernel's arithmetic, one PyTorch
    operation per step. A ``stats`` dict is filled with
    :func:`histogram_stats` of the histogram's floor texels (an element
    hits when its alpha cotangent is not zero)."""
    dev = values.device
    width = _window(windowing_vec4, dev)[1]
    step = float(step_size)
    tf_pos, cut, x, i0, i1, frac = _taps(values, windowing_vec4)
    table = tf_table[:, 3]
    a0, a1 = table[i0], table[i1]
    a_raw = a0 + (a1 - a0) * frac
    one_m = 1.0 - a_raw.clamp(0.0, 1.0)
    logb = torch.log(torch.clamp(one_m, min=1e-10))
    basemask = (one_m >= 1e-10).to(values.dtype)
    dcorr = step * torch.exp((step - 1.0) * logb) * basemask
    keep = (~cut).to(values.dtype)
    ga = g * keep * dcorr * _clip_grad(a_raw)
    gx = ga * (a1 - a0)
    dval = gx * (256.0 / width)
    dc = (gx * (-256.0 / width)).sum()
    dw = (gx * (256.0 * (0.5 - tf_pos) / width)).sum()
    in_rng = (x >= 0.0) & (x < 255.0)
    wa = ga * torch.where(in_rng, 1.0 - frac, torch.ones_like(frac))
    wb = ga * torch.where(in_rng, frac, torch.zeros_like(frac))
    h = torch.zeros((2, 256), dtype=torch.float32, device=dev)
    h[0].index_add_(0, i0.flatten(), wa.flatten())
    h[1].index_add_(0, i0.flatten(), wb.flatten())
    dtf = torch.zeros((256, 4), dtype=torch.float32, device=dev)
    dtf[:, 3] = _assemble(h[0], h[1])
    if stats is not None:
        stats.update(histogram_stats(i0, ga != 0.0))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return dval, dtf, torch.stack([dc, dw, zero, zero])


def windowed_tf_alpha_bwd(values, tf_table, windowing_vec4, step_size: float,
                          g):
    """Cotangents of :func:`windowed_tf_alpha`; see
    :func:`windowed_tf_alpha_bwd_plain`. One device operation: the kernel's
    last block writes d TF and d window. The histogram and the window sums
    reduce in a fixed order: the same bits on every run."""
    if values.device.type == "cpu":
        return windowed_tf_alpha_bwd_plain(values, tf_table, windowing_vec4,
                                           step_size, g)
    dev = values.device
    values = values.contiguous()
    g = g.contiguous()
    tf_table = tf_table.contiguous()
    win = _kernels.window_tensor(windowing_vec4, dev).contiguous()
    for name, t in (("values", values), ("g", g), ("tf_table", tf_table)):
        _kernels.check(t, name, torch.float32, dev)
    if tuple(tf_table.shape) != (256, 4) or g.shape != values.shape:
        raise ValueError("tf_table must be (256, 4) and g shaped as values")
    n = values.numel()
    blocks = max(1, min(-(-n // _BWD_PER_BLOCK), _kernels.sm_count(dev)))
    dval = torch.empty_like(values)
    partials = torch.empty((blocks, _BWD_ROW), dtype=torch.float32,
                           device=dev)
    dtf = torch.empty((256, 4), dtype=torch.float32, device=dev)
    dwin = torch.empty(4, dtype=torch.float32, device=dev)
    stream = _kernels.stream_of(values)
    _kernels.launch(
        "tbr_tf_alpha_bwd", values.data_ptr(), tf_table.data_ptr(),
        win.data_ptr(), g.data_ptr(), dval.data_ptr(), partials.data_ptr(),
        _kernels.done_counter(dev, stream).data_ptr(), dtf.data_ptr(),
        dwin.data_ptr(), n, float(step_size), blocks, stream,
    )
    windowed_tf_alpha_bwd.launches += 1
    return dval, dtf, dwin


windowed_tf_alpha_bwd.launches = 0


class _WindowedTFAlpha(torch.autograd.Function):
    """Forward :func:`windowed_tf_alpha` (K3), backward
    :func:`windowed_tf_alpha_bwd` (K8), both looked up at call time."""

    @staticmethod
    def forward(ctx, values, tf_table, win, step_size):
        ctx.step_size = step_size
        ctx.save_for_backward(values, tf_table, win)
        return windowed_tf_alpha(values, tf_table, win, step_size)

    @staticmethod
    def backward(ctx, g):
        values, tf_table, win = ctx.saved_tensors
        with span(TF_ALPHA_BWD):
            dval, dtf, dwin = windowed_tf_alpha_bwd(values, tf_table, win,
                                                    ctx.step_size, g)
        return dval, dtf.to(tf_table.dtype), dwin, None


def windowed_tf_alpha_vjp(values: torch.Tensor, tf_table: torch.Tensor,
                          windowing_vec4, step_size: float) -> torch.Tensor:
    """Differentiable :func:`windowed_tf_alpha` (the JAX package's
    ``windowed_tf_alpha_vjp``). ``step_size`` is a host number and takes no
    gradient."""
    win = _kernels.window_tensor(windowing_vec4, values.device)
    return _WindowedTFAlpha.apply(values, tf_table, win, float(step_size))
