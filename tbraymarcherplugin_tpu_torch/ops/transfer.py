"""Transfer-function tables: creation, lookup, interval occupancy.

A transfer function is a ``(resolution, 4)`` float32 tensor. Lookup is a
clamp-addressed linear lookup of a 256-wide texture at texel centers
(`WindowedSampling.usf:33`).
"""

from __future__ import annotations

import numpy as np
import torch

TF_RESOLUTION = 256


def default_grayscale_tf(resolution: int = TF_RESOLUTION,
                         device=None) -> torch.Tensor:
    """Grayscale ramp with alpha 1 (reference `MakeDefaultTFTexture`)."""
    ramp = torch.linspace(0.0, 1.0, resolution, dtype=torch.float32,
                          device=device)
    return torch.stack([ramp, ramp, ramp, torch.ones_like(ramp)], dim=-1)


def tf_from_keypoints(positions, colors, resolution: int = TF_RESOLUTION,
                      device=None) -> torch.Tensor:
    """Bake a piecewise-linear RGBA curve into a table, evaluated at
    ``i / (resolution - 1)`` (`RaymarchUtils.cpp:152-162`)."""
    positions = np.asarray(positions, np.float32)
    colors = np.asarray(colors, np.float32)
    xs = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
    out = np.stack(
        [np.interp(xs, positions, colors[:, c]) for c in range(4)], axis=-1
    ).astype(np.float32)
    return torch.from_numpy(out).to(device)


def tf_ct_bone(resolution: int = TF_RESOLUTION, device=None) -> torch.Tensor:
    """The analytic bone-window TF of the JAX package's `tf_ct_bone`."""
    return tf_from_keypoints(
        [0.0, 0.35, 0.5, 0.75, 1.0],
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.4, 0.2, 0.1, 0.0],
            [0.9, 0.8, 0.6, 0.3],
            [1.0, 0.95, 0.85, 0.8],
            [1.0, 1.0, 1.0, 1.0],
        ],
        resolution,
        device,
    )


def sample_tf(tf_table: torch.Tensor, tf_pos: torch.Tensor) -> torch.Tensor:
    """(..., 4) linear TF lookup at ``tf_pos`` with clamp addressing: texel
    centers at (i + 0.5) / R; the fraction is not clipped, both taps are."""
    res = tf_table.shape[0]
    x = tf_pos * res - 0.5
    i0 = torch.floor(x)
    frac = x - i0
    i0c = i0.clamp(0, res - 1).long()
    i1c = (i0 + 1.0).clamp(0, res - 1).long()
    c0 = _TakeRows.apply(tf_table, i0c)
    c1 = _TakeRows.apply(tf_table, i1c)
    return c0 + (c1 - c0) * frac[..., None]


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` for a small table (the 256-texel TF) and many indices,
    by `index_select`, whose adjoint sums the cotangent rows of each index
    with one `torch.bincount` (a shared-memory histogram on the card).
    Indexing's own adjoint sorts the indices and walks each index's
    duplicates one after another: a 1080p block of the dense composite puts
    millions of samples on a few TF texels, and that walk took about 6 s
    per block on an H100; its forward took about 4 ms per lookup.

    On the card `bincount` adds with atomics, so the TF gradient of every
    path through :func:`sample_tf` changes in its last bits from run to
    run. Under ``torch.use_deterministic_algorithms(True)`` the adjoint is
    indexing's deterministic (and slow) sorted accumulation instead."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = tuple(table.shape)
        return table.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        rows, cols = ctx.shape[0], int(np.prod(ctx.shape[1:]))
        bins = (idx.reshape(-1, 1) * cols
                + torch.arange(cols, device=idx.device)).reshape(-1)
        w = g.reshape(-1).to(torch.float32)
        if torch.are_deterministic_algorithms_enabled():
            d = w.new_zeros(rows * cols).index_put_((bins,), w,
                                                    accumulate=True)
        else:
            d = torch.bincount(bins, w, minlength=rows * cols)
        return d.reshape(ctx.shape).to(g.dtype), None


def windowed_tf_range_occupied(mn, mx, windowing_vec4, tf_table):
    """Exact-conservative interval occupancy: can any value in [mn, mx]
    produce a windowed-TF alpha > 0? Trilinear and bilinear samples are
    convex combinations of texels, windowing is affine, cutoffs clip the
    TF interval, and the answer is a prefix-sum query over alpha > 0."""
    center, width = windowing_vec4[0], windowing_vec4[1]
    low_c, high_c = windowing_vec4[2], windowing_vec4[3]
    plo = (mn - center + 0.5 * width) / width
    phi = (mx - center + 0.5 * width) / width
    plo, phi = torch.minimum(plo, phi), torch.maximum(plo, phi)
    plo_eff = torch.where(low_c > 0.0, plo.clamp(min=0.0), plo)
    phi_eff = torch.where(high_c > 0.0, phi.clamp(max=1.0), phi)
    fully_cut = plo_eff > phi_eff

    res = tf_table.shape[0]
    xlo = plo_eff * res - 0.5
    xhi = phi_eff * res - 0.5
    ilo = torch.floor(xlo).nan_to_num(0.0).clamp(0, res - 1).long()
    ihi = (torch.floor(xhi) + 1.0).nan_to_num(0.0).clamp(0, res - 1).long()
    nz = (tf_table[:, 3] > 0.0).to(torch.int32)
    csum = torch.cat([nz.new_zeros(1), torch.cumsum(nz, 0)])
    any_nz = (csum[ihi + 1] - csum[ilo]) > 0
    occ = any_nz & ~fully_cut
    # Degenerate window (width == 0) divides by zero: treat as occupied.
    return occ | ~torch.isfinite(plo) | ~torch.isfinite(phi)
