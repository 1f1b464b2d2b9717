"""The min/max mip pyramid and the occupancy grid of empty-space skipping.

Counterpart of `tbraymarcherplugin_tpu/ops/octree.py` (`build_octree`,
`_dilate3`, `occupancy_grid`): the max-value pyramid over the pow2-padded
volume (`GenerateOctreeShader.usf:28-107`), a min-value pyramid beside it,
and the exact-conservative per-cell occupancy that the blocked march skips
empty blocks with. The pyramids are ``max_pool3d`` reductions; a min is the
negated max of the negated volume. The octree render mode
(`load_mip_nearest`, `march_octree`) comes with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .transfer import windowed_tf_range_occupied

NUM_MIPS = 4  # `OctreeShaders.cpp:45` binds NumMips = 4


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
    """
    if mip < 1:
        raise ValueError("mip must be >= 1 so cells are wider than the "
                         "trilinear footprint after 3^3 dilation")
    mn = _dilate3(octree.min_mips[mip], "min")
    mx = _dilate3(octree.mips[mip], "max")
    win = torch.as_tensor(windowing_vec4, dtype=torch.float32,
                          device=mn.device)
    occ = windowed_tf_range_occupied(mn, mx, win, tf_table)
    cell = 1 << mip
    n_cells = tuple(-(-d // cell) for d in octree.data_dims)
    occ = occ[: n_cells[0], : n_cells[1], : n_cells[2]]
    scale = tuple(d / float(cell) for d in octree.data_dims)
    return OccupancyGrid(grid=occ.contiguous(), cell_scale=scale)
