"""The min/max mip pyramid, the octree render mode's march and the
occupancy grid of empty-space skipping.

Counterpart of `tbraymarcherplugin_tpu/ops/octree.py`: the max-value
pyramid over the pow2-padded volume (`GenerateOctreeShader.usf:28-107`), a
min-value pyramid beside it, :func:`march_octree`
(`PerformWindowedRaymarchOctree`, `WindowedRaymarchMaterials.usf:99-183`)
with its nearest-texel :func:`load_mip_nearest`, and the
exact-conservative per-cell occupancy that the blocked march skips empty
blocks with. The pyramids are ``max_pool3d`` reductions; a min is the
negated max of the negated volume. Plain PyTorch: the JAX package has no
kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .compositing import EARLY_TERMINATION_ALPHA, accumulate
from .march import _as_device, _loop_bound, _march_state
from .rays import RayBatch
from .sampling import (VOLUME_DENSITY, is_clipped,
                       sample_windowed_transfer_function)
from .transfer import windowed_tf_range_occupied

NUM_MIPS = 4  # `OctreeShaders.cpp:45` binds NumMips = 4
# A rounded lerp a * (1 - f) + b * f can land an ulp or two outside
# [min(a, b), max(a, b)], so a trilinear sample (three levels of lerps) can
# leave its voxels' range by a few ulps of their magnitude. A range widened
# by 2^-18 of its magnitude (64 ulps) holds every sample the march takes.
LERP_MARGIN = 2.0 ** -18


class Octree(NamedTuple):
    """Max-value (``mips``) and min-value (``min_mips``) pyramids over the
    pow2-padded volume: ``mips[0]`` has the padded shape, each next mip
    halves every dimension; ``data_dims`` are the unpadded dimensions."""

    mips: tuple
    data_dims: tuple
    min_mips: tuple


class OccupancyGrid(NamedTuple):
    """``grid[c]`` is False only when no sample whose position falls in
    coarse cell ``c`` can have a windowed-TF alpha above 0;
    ``cell = floor(uvw * cell_scale)``, clamped."""

    grid: torch.Tensor  # (GX, GY, GZ) bool
    cell_scale: tuple


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0):
    return F.max_pool3d(x[None, None], kernel, stride, padding)[0, 0]


def _build_mips(padded: torch.Tensor, num_mips: int, op: str = "max"):
    sign = 1.0 if op == "max" else -1.0
    mips = [padded]
    for _ in range(num_mips - 1):
        mips.append(sign * _max_pool(sign * mips[-1], 2, 2))
    return tuple(mips)


def build_octree(volume: torch.Tensor, max_value: float = 1.0,
                 num_mips: int = NUM_MIPS) -> Octree:
    """The max pyramid of the volume times ``max_value`` (`usf:45`),
    zero-padded to pow2 dimensions, and the min pyramid beside it (the zero
    padding can only widen the ranges of boundary cells)."""
    dims = tuple(volume.shape)
    padded = volume.new_zeros(tuple(_next_pow2(d) for d in dims))
    padded[: dims[0], : dims[1], : dims[2]] = volume * max_value
    return Octree(mips=_build_mips(padded, num_mips, "max"), data_dims=dims,
                  min_mips=_build_mips(padded, num_mips, "min"))


def load_mip_nearest(mip: torch.Tensor, voxel_pos: torch.Tensor) -> torch.Tensor:
    """Integer-truncation texel load (`Texture3D.Load`) of ``mip`` at
    (..., 3) texel coordinates, each index clamped to the mip."""
    idx = voxel_pos.to(torch.int32).long()  # truncates toward zero
    ix = idx[..., 0].clamp(0, mip.shape[0] - 1)
    iy = idx[..., 1].clamp(0, mip.shape[1] - 1)
    iz = idx[..., 2].clamp(0, mip.shape[2] - 1)
    return mip.reshape(-1)[(ix * mip.shape[1] + iy) * mip.shape[2] + iz]


def march_octree(octree: Octree, tf_table: torch.Tensor, rays: RayBatch,
                 windowing_vec4, clip_center, clip_direction, jitter=None,
                 step_count: int = 150, mip: int = 0,
                 early_termination: float = EARLY_TERMINATION_ALPHA
                 ) -> torch.Tensor:
    """The octree mode's march (`PerformWindowedRaymarchOctree`,
    usf:99-183) -> (..., 4) RGBA: unlit, mip ``mip`` sampled with nearest
    loads. UVW scales into the mip's texels, the z coordinate by data depth
    / padded depth to cancel the pow2 padding (usf:149-151). The final
    fractional step keeps the main loop's opacity step."""
    mip_arr = octree.mips[mip]
    win = _as_device(windowing_vec4, mip_arr)
    cc, cd = (_as_device(x, mip_arr) for x in (clip_center, clip_direction))
    st = _march_state(rays, step_count, jitter)
    step_world = VOLUME_DENSITY * st.step_size
    z_rescale = octree.data_dims[2] / octree.mips[0].shape[2]
    scale = (torch.tensor(mip_arr.shape, dtype=torch.float32,
                          device=mip_arr.device)
             * torch.tensor([1.0, 1.0, z_rescale], dtype=torch.float32,
                            device=mip_arr.device))

    def sample_at(pos):
        value = load_mip_nearest(mip_arr, pos * scale)
        return sample_windowed_transfer_function(value, step_world, tf_table,
                                                 win)

    ray_shape = rays.thickness.shape
    pos = st.pos0
    energy = torch.zeros(ray_shape + (4,), device=pos.device)
    terminated = torch.zeros(ray_shape, dtype=torch.bool, device=pos.device)
    for i in range(_loop_bound(st.n_full, step_count)):
        in_range = i < st.n_full
        pos = torch.where(in_range[..., None], pos + st.step_vec, pos)
        active = in_range & ~terminated & ~is_clipped(pos, cc, cd)
        energy = torch.where(active[..., None],
                             accumulate(energy, sample_at(pos)), energy)
        over = active & (energy[..., 3] > early_termination)
        energy = torch.cat([energy[..., :3], torch.where(
            over, torch.ones_like(energy[..., 3]), energy[..., 3])[..., None]],
            -1)
        terminated = terminated | over

    pos_f = pos + st.step_vec * st.final_frac[..., None]
    active_f = (~terminated & (st.final_frac > 0.0)
                & ~is_clipped(pos_f, cc, cd))
    return torch.where(active_f[..., None],
                       accumulate(energy, sample_at(pos_f)), energy)


def _dilate3(x: torch.Tensor, op: str) -> torch.Tensor:
    """3x3x3 neighbourhood max or min, SAME-padded with -inf or +inf."""
    sign = 1.0 if op == "max" else -1.0
    return sign * _max_pool(sign * x, 3, 1, 1)


def occupancy_grid(octree: Octree, windowing_vec4, tf_table: torch.Tensor,
                   mip: int = NUM_MIPS - 1) -> OccupancyGrid:
    """Exact-conservative occupancy per coarse cell of mip ``mip`` (>= 1).

    A cell's value range is the min/max pyramid's over its 3^3
    neighbourhood (a trilinear footprint reaches one voxel past the cell a
    sample falls in, and a cell is at least two voxels wide), trilinear
    samples are convex combinations of voxels, and
    :func:`.transfer.windowed_tf_range_occupied` answers whether any value
    of that range has a windowed-TF alpha above 0. Cells that cover only
    pow2 padding are dropped: the march clamps cell indices to the data.
    Each range is widened by ``LERP_MARGIN`` of its magnitude before the
    test, so the grid also holds against the rounding of the lerps and a
    march that skips its empty cells changes no bit
    (`fused_march.march_lit_fused`): it holds every cell of the JAX
    package's grid, which has no margin, and may hold a few more.
    """
    if mip < 1:
        raise ValueError("mip must be >= 1 so cells are wider than the "
                         "trilinear footprint after 3^3 dilation")
    mn = _dilate3(octree.min_mips[mip], "min")
    mx = _dilate3(octree.mips[mip], "max")
    pad = LERP_MARGIN * torch.maximum(mn.abs(), mx.abs())
    mn, mx = mn - pad, mx + pad
    win = torch.as_tensor(windowing_vec4, dtype=torch.float32,
                          device=mn.device)
    occ = windowed_tf_range_occupied(mn, mx, win, tf_table)
    cell = 1 << mip
    n_cells = tuple(-(-d // cell) for d in octree.data_dims)
    occ = occ[: n_cells[0], : n_cells[1], : n_cells[2]]
    scale = tuple(d / float(cell) for d in octree.data_dims)
    return OccupancyGrid(grid=occ.contiguous(), cell_scale=scale)
