"""Volume sampling: trilinear interpolation, windowed TF steps, soft clip.

Volumes are ``(X, Y, Z)`` float32 tensors; UVW (u, v, w) in [0, 1]^3
addresses axes 0/1/2 with texel centers at (i + 0.5) / dim
(`WindowedSampling.usf`, `RaymarcherCommon.usf`).
"""

from __future__ import annotations

import torch

from .transfer import sample_tf

# Fixed density multiplier of step sizes (`RaymarcherCommon.usf:15-18`).
VOLUME_DENSITY = 100.0

ONE_OVER_SQRT_3 = 0.57735026919


def trilinear_sample(volume: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """Clamp-addressed trilinear sample of (X, Y, Z) ``volume`` at (..., 3)
    UVW coordinates (`Volume.SampleLevel(ClampSampler, UVW, 0)`)."""
    dims = torch.tensor(volume.shape, dtype=torch.float32, device=uvw.device)
    p = uvw * dims - 0.5
    i0 = torch.floor(p)
    frac = p - i0
    i0 = i0.long()
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


def transfer_func_position(value, center, width):
    """Windowing: data value -> TF coordinate (`WindowedSampling.usf:14-17`)."""
    return (value - center + width * 0.5) / width


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] with XLA's subgradient of ``jnp.clip``: 1
    inside, 0.5 at an exact bound (TF alpha plateaus sit at exactly 0), 0
    outside; ``torch.clamp`` would pass 1 at the bounds."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def correct_for_step_size(intensity, step_size):
    """Opacity correction ``1 - (1 - a)^step`` (`RaymarcherCommon.usf:46-49`),
    written ``1 - exp(step * log(max(1 - a, 1e-10)))`` as the kernels do."""
    base = torch.clamp(1.0 - intensity, min=1e-10)
    return 1.0 - torch.exp(step_size * torch.log(base))


def sample_windowed_transfer_function(value, step_size, tf_table,
                                      windowing_vec4) -> torch.Tensor:
    """Window, TF lookup and step-corrected alpha -> (..., 4) RGBA; TF
    positions below 0 (low cutoff) or above 1 (high cutoff) give zero
    (`WindowedSampling.usf:20-37`)."""
    center, width = windowing_vec4[0], windowing_vec4[1]
    low_c, high_c = windowing_vec4[2], windowing_vec4[3]
    tf_pos = transfer_func_position(value, center, width)
    cut = ((tf_pos < 0.0) & (low_c > 0.0)) | ((tf_pos > 1.0) & (high_c > 0.0))
    color = sample_tf(tf_table, tf_pos)
    alpha = correct_for_step_size(clip01(color[..., 3]), step_size)
    rgba = torch.cat([color[..., :3], alpha[..., None]], dim=-1)
    return torch.where(cut[..., None], torch.zeros_like(rgba), rgba)


def is_clipped(uvw, clip_center, clip_direction) -> torch.Tensor:
    """Half-space clip test (`RaymarcherCommon.usf:22-25`): True where
    ``dot(P - center, dir) <= 0``, the dot product summed x, y, then z."""
    cc = torch.as_tensor(clip_center, dtype=torch.float32, device=uvw.device)
    cd = torch.as_tensor(clip_direction, dtype=torch.float32,
                         device=uvw.device)
    d = (uvw - cc) * cd
    return d[..., 0] + d[..., 1] + d[..., 2] <= 0.0


def clip_soft_alpha_weight(uvw, clip_center, clip_direction, resolution):
    """Soft clip weight of light propagation (`AddDirLightShader.usf:87-105`):
    the un-clipped fraction of a voxel, approximated from its distance to
    the plane in voxel units. Returns (...,) weights in [0, 1]."""
    dev = uvw.device
    res = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    cc = torch.as_tensor(clip_center, dtype=torch.float32, device=dev)
    cd = torch.as_tensor(clip_direction, dtype=torch.float32, device=dev)
    dist = ((uvw - cc) * cd).sum(-1)
    offset = cd * dist[..., None] * res
    voxel_distance = torch.linalg.vector_norm(offset, dim=-1)
    return (0.5 + ONE_OVER_SQRT_3 * voxel_distance * torch.sign(dist)).clamp(
        0.0, 1.0
    )
