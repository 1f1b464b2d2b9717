"""Shared pieces of the reference: constants, transfer-function tables,
the windowed lookup, trilinear sampling, the clip weight and the jitter
hash.

Frozen copies of `tbraymarcherplugin_tpu_torch/ops/transfer.py`,
`ops/sampling.py`, `ops/compositing.py` and `ops/rays.py` (the parts the
reference needs), plain PyTorch and numpy. Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch

TF_RESOLUTION = 256
VOLUME_DENSITY = 100.0
EARLY_TERMINATION_ALPHA = 0.95
ONE_OVER_SQRT_3 = 0.57735026919
_MASK32 = 0xFFFFFFFF

# The analytic CT curves (keypoint positions, RGBA at each), as the
# program's `ops/transfer.py` bakes them.
TF_KEYPOINTS = {
    "ct_bone": ([0.0, 0.35, 0.5, 0.75, 1.0],
                [[0.0, 0.0, 0.0, 0.0], [0.4, 0.2, 0.1, 0.0],
                 [0.9, 0.8, 0.6, 0.3], [1.0, 0.95, 0.85, 0.8],
                 [1.0, 1.0, 1.0, 1.0]]),
    "ct_soft_tissue": ([0.0, 0.2, 0.45, 0.7, 1.0],
                       [[0.0, 0.0, 0.0, 0.0], [0.6, 0.2, 0.15, 0.05],
                        [0.8, 0.5, 0.35, 0.25], [0.95, 0.85, 0.7, 0.6],
                        [1.0, 1.0, 0.95, 0.9]]),
}


def tf_table(name: str, device=None) -> torch.Tensor:
    """(256, 4) float32 table of the curve ``name``: the piecewise-linear
    RGBA curve evaluated at ``i / 255`` (`RaymarchUtils.cpp:152-162`)."""
    positions, colors = TF_KEYPOINTS[name]
    positions = np.asarray(positions, np.float32)
    colors = np.asarray(colors, np.float32)
    xs = np.linspace(0.0, 1.0, TF_RESOLUTION, dtype=np.float32)
    out = np.stack([np.interp(xs, positions, colors[:, c]) for c in range(4)],
                   axis=-1).astype(np.float32)
    return torch.from_numpy(out).to(device)


def tf_taps(values: torch.Tensor, win):
    """(tf_pos, cut, i0, i1, frac) of the windowed, clamp-addressed
    256-texel lookup of ``values``; ``win`` is (center, width, low cutoff,
    high cutoff) as floats."""
    center, width, low_c, high_c = win
    tf_pos = (values - center + width * 0.5) / width
    cut = ((tf_pos < 0.0) & (low_c > 0.0)) | ((tf_pos > 1.0) & (high_c > 0.0))
    x = tf_pos * 256.0 - 0.5
    i0f = torch.floor(x)
    frac = x - i0f
    i0f = i0f.nan_to_num(0.0)
    i0 = i0f.clamp(0.0, 255.0).long()
    i1 = (i0f + 1.0).clamp(0.0, 255.0).long()
    return tf_pos, cut, i0, i1, frac


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (256, C) or (256,) table, through
    ``index_select``. Where the table takes a gradient, the lookup reads a
    float64 copy (the same values): its adjoint, an indexed add of up to
    millions of cotangents into one texel, then sums in float64, where a
    float32 sum of that many terms drifts by percents."""
    src = table.double() if table.requires_grad else table
    flat = torch.index_select(src, 0, idx.reshape(-1)).to(table.dtype)
    return flat.reshape(*idx.shape, *table.shape[1:])


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1], with the derivative 1/2 at an exact bound
    (as ``min(max(x, 0), 1)`` splits it between equal arguments): the TF's
    alpha plateaus sit at exactly 0, where a one-sided derivative would
    count their texels' gradient twice or not at all."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def step_alpha(alpha: torch.Tensor, step) -> torch.Tensor:
    """The opacity correction ``1 - exp(step * log(max(1 - a, 1e-10)))``
    of an alpha already clamped to [0, 1]."""
    return 1.0 - torch.exp(step * torch.log(torch.clamp(1.0 - alpha,
                                                        min=1e-10)))


def windowed_tf_alpha(values, table, win, step: float) -> torch.Tensor:
    """Step-corrected windowed TF alpha per element, 0 where cut."""
    _, cut, i0, i1, frac = tf_taps(values, win)
    a0, a1 = lookup(table[:, 3], i0), lookup(table[:, 3], i1)
    alpha = step_alpha(clip01(a0 + (a1 - a0) * frac), float(step))
    return torch.where(cut, torch.zeros_like(alpha), alpha)


def windowed_tf_range_occupied(mn, mx, win, table):
    """Can any value in [mn, mx] give a windowed-TF alpha above 0? A
    prefix-sum query over the texels of alpha > 0 between the window's
    images of ``mn`` and ``mx`` (cutoffs clip the interval)."""
    center, width, low_c, high_c = win
    plo = (mn - center + 0.5 * width) / width
    phi = (mx - center + 0.5 * width) / width
    plo, phi = torch.minimum(plo, phi), torch.maximum(plo, phi)
    plo_eff = plo.clamp(min=0.0) if low_c > 0.0 else plo
    phi_eff = phi.clamp(max=1.0) if high_c > 0.0 else phi
    fully_cut = plo_eff > phi_eff
    res = table.shape[0]
    ilo = torch.floor(plo_eff * res - 0.5).nan_to_num(0.0).clamp(
        0, res - 1).long()
    ihi = (torch.floor(phi_eff * res - 0.5) + 1.0).nan_to_num(0.0).clamp(
        0, res - 1).long()
    nz = (table[:, 3] > 0.0).to(torch.int32)
    csum = torch.cat([nz.new_zeros(1), torch.cumsum(nz, 0)])
    occ = ((csum[ihi + 1] - csum[ilo]) > 0) & ~fully_cut
    return occ | ~torch.isfinite(plo) | ~torch.isfinite(phi)


def trilinear_sample(volume: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """Clamp-addressed trilinear sample of (X, Y, Z) ``volume`` at (..., 3)
    UVW coordinates."""
    dims = torch.tensor(volume.shape, dtype=torch.float32, device=uvw.device)
    p = uvw * dims - 0.5
    i0 = torch.floor(p)
    frac = p - i0
    i0 = i0.nan_to_num(0.0).long()
    sy = volume.shape[1] * volume.shape[2]
    sz = volume.shape[2]
    flat = volume.reshape(-1)

    def ax_idx(a, off):
        return (i0[..., a] + off).clamp(0, volume.shape[a] - 1)

    def corner(dx, dy, dz):
        return flat[ax_idx(0, dx) * sy + ax_idx(1, dy) * sz + ax_idx(2, dz)]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def clip_soft_alpha_weight(uvw, clip_center, clip_direction, resolution):
    """The light propagation's soft clip weight
    (`AddDirLightShader.usf:87-105`): the unclipped fraction of a voxel
    from its distance to the plane in voxel units, in [0, 1]."""
    dev = uvw.device
    res = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    cc = torch.as_tensor(clip_center, dtype=torch.float32, device=dev)
    cd = torch.as_tensor(clip_direction, dtype=torch.float32, device=dev)
    dist = ((uvw - cc) * cd).sum(-1)
    voxel_distance = torch.linalg.vector_norm(cd * dist[..., None] * res,
                                              dim=-1)
    return (0.5 + ONE_OVER_SQRT_3 * voxel_distance
            * torch.sign(dist)).clamp(0.0, 1.0)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for int64 ``v`` in [0, 2^32)."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def jitter_values(width: int, height: int, frame_index: int,
                  device=None) -> torch.Tensor:
    """(height, width) per-pixel temporal jitter in [0, 1): a PCG-style
    hash of (x, y, frame_index % 8) (`RaymarchMaterialCommon.usf:73-78`)."""
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    y = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    x, y = x.expand(height, width), y.expand(height, width)
    z = torch.full((height, width), frame_index % 8, dtype=torch.int64,
                   device=device)
    v = (_mul32(x, 1664525) + _mul32(y, 1013904223)
         + _mul32(z, 69069)) & _MASK32
    v = v ^ (v >> 16)
    v = _mul32(v, 2654435769)
    v = v ^ (v >> 13)
    v = _mul32(v, 2654435769)
    v = v ^ (v >> 16)
    return (v & 0xFFFF).to(torch.float32) / 65535.0
