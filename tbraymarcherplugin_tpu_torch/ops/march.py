"""The forward ray march: front-to-back windowed emission-absorption rendering.

Counterpart of `tbraymarcherplugin_tpu/ops/march.py`, the reference's
material-shader march loops (`WindowedRaymarchMaterials.usf`):

- :func:`march_lit`         <- `PerformWindowedLitRaymarch` (`:36-96`), step
  by step;
- :func:`march_lit_blocked` the same march in blocks of steps, compositing
  each block with a cumulative product, with empty-space skipping;
- :func:`march_lit_tiled`   the blocked march over bounded groups of rays;
- :func:`march_intensity`   <- `PerformWindowedIntensityRaymarch`
  (`:187-242`).

Plain PyTorch, differentiable through autograd: the JAX side is XLA, not
Pallas. The per-ray ``for``/``break`` of the shader is a loop over steps
with masks, so early termination and per-ray step counts are exact and
differentiable. For the backward, the loop runs in chunks of steps, each
under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``):
the backward recomputes a chunk instead of keeping every step's sample
fields. The loop stops after the longest ray's last step; the steps the
JAX package's static bound adds after it change nothing.

The final fractional step passes ``VOLUME_DENSITY * final_frac`` as its
opacity-correction step (`WindowedRaymarchMaterials.usf:91`), a factor of
``step_count`` off the main loop's; ``compat_final_step=True`` keeps that
quirk for parity, False makes it consistent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .compositing import EARLY_TERMINATION_ALPHA, accumulate
from .rays import RayBatch
from .sampling import (
    VOLUME_DENSITY,
    is_clipped,
    sample_windowed_transfer_function,
    transfer_func_position,
    trilinear_sample,
)

SQRT_3 = math.sqrt(3.0)

# Rays per group of march_lit_tiled: bounds the (block_size, rays) sample
# fields of the blocked march.
DEFAULT_TILE_SIZE = 131072


def max_march_steps(step_count: int) -> int:
    """Bound on per-ray steps: the cube diagonal is sqrt(3) thick."""
    return int(math.ceil(step_count * SQRT_3))


class MarchState(NamedTuple):
    """Per-ray march quantities: the jittered start ``pos0`` (..., 3), the
    step vector (..., 3), the number of full steps and the remainder
    (...,), and the scalar step size."""

    pos0: torch.Tensor
    step_vec: torch.Tensor
    n_full: torch.Tensor
    final_frac: torch.Tensor
    step_size: float


def _march_state(rays: RayBatch, step_count: int, jitter=None) -> MarchState:
    """The march's start state; ``jitter`` (...,) in [0, 1) moves the start
    back along the ray by that fraction of a step
    (`RaymarchMaterialCommon.usf:73-78`)."""
    step_size = 1.0 / step_count
    step_vec = rays.direction * step_size
    float_actual = step_count * rays.thickness
    n_full = torch.floor(float_actual)
    final_frac = float_actual - n_full
    pos0 = rays.entry
    if jitter is not None:
        jitter = torch.as_tensor(jitter, dtype=torch.float32,
                                 device=pos0.device)
        pos0 = pos0 - step_vec * jitter[..., None]
    return MarchState(pos0, step_vec, n_full, final_frac, step_size)


def _as_device(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, np.ndarray):  # a read-only array (as JAX hands out)
        x = np.array(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _run(fn, grad: bool, *args):
    """``fn(*args)``, under a non-reentrant checkpoint when a gradient is
    being recorded."""
    if grad:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mark(group, *tensors):
    """``tensors`` through `parallel.overlap.psum_cotangent` over the
    process group ``group`` (as they are for None): the march's
    cotangents all-reduce at its entry, before the illumination's
    backward runs."""
    if group is None:
        return tensors
    from ..parallel.overlap import psum_cotangent

    return tuple(psum_cotangent(t, group) for t in tensors)


def _loop_bound(n_full: torch.Tensor, step_count: int) -> int:
    """Steps the loop must run: the longest ray's, capped at the static
    bound (a host read of max(n_full))."""
    if n_full.numel() == 0:
        return 0
    longest = float(n_full.max())
    if not math.isfinite(longest):  # NaN rays (grazing misses) never step
        longest = float(torch.nan_to_num(n_full, nan=0.0).max())
    return min(max_march_steps(step_count), max(int(longest), 0))


def _lit_sample(volume, tf_table, light_volume, pos, step_world, win):
    """(..., 4) RGBA of the samples at ``pos``: windowed TF of the volume,
    rgb times the light volume sampled at the clamped position."""
    rgba = sample_windowed_transfer_function(
        trilinear_sample(volume, pos), step_world, tf_table, win)
    light = trilinear_sample(light_volume, pos.clamp(0.0, 1.0))
    return torch.cat([rgba[..., :3] * light[..., None], rgba[..., 3:]], -1)


def _final_step(energy, pos_f, volume, tf_table, light_volume,
                st: MarchState, terminated, win, cc, cd, compat_final_step):
    """The fractional final step (usf:84-93) at ``pos_f``, for rays that
    ran to completion; it never snaps alpha."""
    active_f = (~terminated & (st.final_frac > 0.0)
                & ~is_clipped(pos_f, cc, cd))
    final_step_world = (VOLUME_DENSITY * st.final_frac if compat_final_step
                        else VOLUME_DENSITY * st.step_size * st.final_frac)
    rgba_f = _lit_sample(volume, tf_table, light_volume, pos_f,
                         final_step_world, win)
    return torch.where(active_f[..., None], accumulate(energy, rgba_f), energy)


def march_lit(volume, tf_table, light_volume, rays: RayBatch, windowing_vec4,
              clip_center, clip_direction, jitter=None, step_count: int = 150,
              early_termination: float = EARLY_TERMINATION_ALPHA,
              checkpoint_every: int = 32,
              compat_final_step: bool = True) -> torch.Tensor:
    """Lit front-to-back march (`PerformWindowedLitRaymarch`, usf:36-96),
    one step at a time -> (..., 4) RGBA.

    ``volume`` (X, Y, Z); ``tf_table`` (R, 4); ``light_volume`` (LX, LY, LZ),
    possibly half resolution, modulates each sample's rgb; ``windowing_vec4``
    (center, width, low cutoff, high cutoff); samples with ``dot(P - center,
    dir) <= 0`` are clipped; ``jitter`` (...,) in [0, 1).
    """
    win = _as_device(windowing_vec4, volume)
    cc, cd = _as_device(clip_center, volume), _as_device(clip_direction,
                                                         volume)
    st = _march_state(rays, step_count, jitter)
    step_world = VOLUME_DENSITY * st.step_size
    grad = _needs_grad(volume, tf_table, light_volume, win)

    def chunk(pos, energy, terminated, start, stop):
        for i in range(start, stop):
            in_range = i < st.n_full
            pos = torch.where(in_range[..., None], pos + st.step_vec, pos)
            active = in_range & ~terminated & ~is_clipped(pos, cc, cd)
            rgba = _lit_sample(volume, tf_table, light_volume, pos,
                               step_world, win)
            energy = torch.where(active[..., None], accumulate(energy, rgba),
                                 energy)
            # Early termination: alpha snaps to 1 (usf:75-79).
            hit = active & (energy[..., 3] > early_termination)
            energy = torch.cat([energy[..., :3], torch.where(
                hit, torch.ones_like(energy[..., 3]), energy[..., 3])[..., None]],
                -1)
            terminated = terminated | hit
        return pos, energy, terminated

    ray_shape = rays.thickness.shape
    pos = st.pos0
    energy = torch.zeros(ray_shape + (4,), device=pos.device)
    terminated = torch.zeros(ray_shape, dtype=torch.bool, device=pos.device)
    n_steps = _loop_bound(st.n_full, step_count)
    for start in range(0, n_steps, checkpoint_every):
        pos, energy, terminated = _run(
            chunk, grad, pos, energy, terminated, start,
            min(start + checkpoint_every, n_steps))

    # the final step starts from where the loop left the ray
    return _final_step(energy, pos + st.step_vec * st.final_frac[..., None],
                       volume, tf_table, light_volume, st, terminated, win,
                       cc, cd, compat_final_step)


def _occ_lookup(occ_grid: torch.Tensor, occ_scale, pos: torch.Tensor):
    """Nearest-cell occupancy: cell = floor(pos * scale), clamped."""
    gx, gy, gz = occ_grid.shape
    sc = torch.as_tensor(occ_scale, dtype=torch.float32, device=pos.device)
    idx = torch.floor(pos * sc).long()
    ix = idx[..., 0].clamp(0, gx - 1)
    iy = idx[..., 1].clamp(0, gy - 1)
    iz = idx[..., 2].clamp(0, gz - 1)
    return occ_grid.reshape(-1)[(ix * gy + iy) * gz + iz]


def march_lit_blocked(volume, tf_table, light_volume, rays: RayBatch,
                      windowing_vec4, clip_center, clip_direction,
                      jitter=None, step_count: int = 150,
                      early_termination: float = EARLY_TERMINATION_ALPHA,
                      block_size: int = 32, compat_final_step: bool = True,
                      occ_grid=None, occ_scale=None, skip_blocks: bool = False,
                      grad_allreduce_axis=None) -> torch.Tensor:
    """The lit march of :func:`march_lit` in blocks of ``block_size`` steps
    -> (..., 4) RGBA.

    Within a block every sample position is known up front (step i samples
    ``pos0 + (i + 1) * step_vec``), so the fetches of a block are one
    batched gather and the front-to-back composite is an exclusive
    cumulative product of (1 - alpha) and a weighted sum. Early termination
    is exact: the first step whose accumulated alpha crosses the threshold
    still contributes, later ones do not, and alpha snaps to 1.

    ``skip_blocks``: skip a block when every ray has terminated, or, with
    ``occ_grid``/``occ_scale`` from :func:`.octree.occupancy_grid`, when no
    in-range sample of the block lands in an occupied cell. Both tests are
    exact for the image: skipped samples have alpha exactly 0. As in the
    JAX package, a skipped block gives exact zeros for the TF and window
    cotangents of those samples, so skip only for inference.
    """
    win = _as_device(windowing_vec4, volume)
    volume, tf_table, win = _mark(grad_allreduce_axis, volume, tf_table, win)
    cc, cd = _as_device(clip_center, volume), _as_device(clip_direction,
                                                         volume)
    st = _march_state(rays, step_count, jitter)
    step_world = VOLUME_DENSITY * st.step_size
    grad = _needs_grad(volume, tf_table, light_volume, win)
    ray_shape = rays.thickness.shape
    dev = st.pos0.device
    bshape = (block_size,) + (1,) * len(ray_shape)
    step_ids = torch.arange(block_size, device=dev).reshape(bshape)

    def positions(b):
        ks = (b * block_size + torch.arange(block_size, device=dev)).to(
            torch.float32).reshape(bshape)
        pos = st.pos0[None] + st.step_vec[None] * (ks + 1.0)[..., None]
        return pos, ks < st.n_full[None]

    def do(rgb_acc, alpha_acc, terminated, b):
        pos, in_range = positions(b)
        m = in_range & ~is_clipped(pos, cc, cd)
        rgba = _lit_sample(volume, tf_table, light_volume, pos, step_world,
                           win)
        zero = rgba.new_zeros(())
        a = torch.where(m, rgba[..., 3], zero)
        rgb = torch.where(m[..., None], rgba[..., :3], zero)
        t_incl = torch.cumprod(1.0 - a, dim=0)  # prod_{j<=k} (1 - a_j)
        t_excl = torch.cat([torch.ones_like(t_incl[:1]), t_incl[:-1]], 0)
        # accumulated alpha after each step, from alpha_acc at block entry
        alpha_after = alpha_acc[None] + (1.0 - alpha_acc[None]) * (1.0 - t_incl)
        crossed = m & (alpha_after > early_termination)
        any_crossed = crossed.any(0)
        # the first crossing step still contributes (the reference
        # composites, then checks); later steps do not
        kc = crossed.to(torch.uint8).argmax(0)
        contrib = torch.where(any_crossed[None], step_ids <= kc[None],
                              torch.ones_like(crossed))
        contrib = contrib & ~terminated[None]
        w = torch.where(contrib, t_excl * a, zero)
        rgb_out = rgb_acc + (1.0 - alpha_acc)[..., None] * (
            w[..., None] * rgb).sum(0)
        alpha_noterm = alpha_acc + (1.0 - alpha_acc) * (1.0 - t_incl[-1])
        newly = any_crossed & ~terminated
        alpha_out = torch.where(
            newly, torch.ones_like(alpha_acc),
            torch.where(terminated, alpha_acc, alpha_noterm))
        return rgb_out, alpha_out, terminated | any_crossed

    rgb = torch.zeros(ray_shape + (3,), device=dev)
    alpha = torch.zeros(ray_shape, device=dev)
    terminated = torch.zeros(ray_shape, dtype=torch.bool, device=dev)
    n_steps = _loop_bound(st.n_full, step_count)
    for b in range(-(-n_steps // block_size)):
        if skip_blocks:
            if bool(terminated.all()):
                continue
            if occ_grid is not None:
                pos, in_range = positions(b)
                if not bool((in_range
                             & _occ_lookup(occ_grid, occ_scale, pos)).any()):
                    continue
        rgb, alpha, terminated = _run(do, grad, rgb, alpha, terminated, b)
    energy = torch.cat([rgb, alpha[..., None]], -1)
    pos_f = st.pos0 + st.step_vec * (st.n_full + st.final_frac)[..., None]
    return _final_step(energy, pos_f, volume, tf_table, light_volume, st,
                       terminated, win, cc, cd, compat_final_step)


def march_lit_tiled(volume, tf_table, light_volume, rays: RayBatch,
                    windowing_vec4, clip_center, clip_direction, jitter=None,
                    step_count: int = 150,
                    early_termination: float = EARLY_TERMINATION_ALPHA,
                    block_size: int = 32, tile_size: int = DEFAULT_TILE_SIZE,
                    compat_final_step: bool = True, occ_grid=None,
                    occ_scale=None, skip_blocks: bool = False,
                    tile2d: tuple | None = None,
                    grad_allreduce_axis=None) -> torch.Tensor:
    """:func:`march_lit_blocked` over groups of at most ``tile_size`` rays:
    memory is O(tile_size * block_size) at any image size, and each ray's
    result equals the blocked march's.

    ``tile2d=(th, tw)`` (2D ray batches only) orders the rays in th x tw
    image rectangles, whole rectangles per group, so that a group's rays are
    close in space, which is what lets ``skip_blocks`` skip (a block is
    skipped only when every ray of the group may skip it). The rectangles
    of a group run as one batch.
    """
    # marked once here, not per group: the cotangent is the sum over groups
    windowing_vec4 = _as_device(windowing_vec4, volume)
    volume, tf_table, windowing_vec4 = _mark(grad_allreduce_axis, volume,
                                             tf_table, windowing_vec4)
    ray_shape = rays.thickness.shape
    entry, direction, thickness = rays
    jit = None if jitter is None else _as_device(jitter, entry)
    if tile2d is not None and len(ray_shape) == 2:
        th, tw = tile2d
        h, w = ray_shape
        hp, wp = -(-h // th) * th, -(-w // tw) * tw

        def to_tiles(x, cval=0.0):
            x = torch.nn.functional.pad(
                x.movedim((0, 1), (-2, -1)), (0, wp - w, 0, hp - h),
                value=cval).movedim((-2, -1), (0, 1))
            x = x.reshape((hp // th, th, wp // tw, tw) + x.shape[2:])
            return x.transpose(1, 2).reshape((-1,) + x.shape[4:])

        # zero-thickness padding rays are no-ops
        tiled = RayBatch(to_tiles(entry), to_tiles(direction, 1.0),
                         to_tiles(thickness))
        out = march_lit_tiled(
            volume, tf_table, light_volume, tiled, windowing_vec4,
            clip_center, clip_direction,
            jitter=None if jit is None else to_tiles(jit),
            step_count=step_count, early_termination=early_termination,
            block_size=block_size,
            tile_size=max(1, tile_size // (th * tw)) * th * tw,
            compat_final_step=compat_final_step, occ_grid=occ_grid,
            occ_scale=occ_scale, skip_blocks=skip_blocks)
        out = out.reshape(hp // th, wp // tw, th, tw, 4).transpose(1, 2)
        return out.reshape(hp, wp, 4)[:h, :w]

    n = thickness.numel()
    entry, direction = entry.reshape(n, 3), direction.reshape(n, 3)
    thickness = thickness.reshape(n)
    jit = None if jit is None else jit.reshape(n)
    outs = []
    for s in range(0, n, tile_size):
        sl = slice(s, s + tile_size)
        outs.append(march_lit_blocked(
            volume, tf_table, light_volume,
            RayBatch(entry[sl], direction[sl], thickness[sl]),
            windowing_vec4, clip_center, clip_direction,
            jitter=None if jit is None else jit[sl], step_count=step_count,
            early_termination=early_termination, block_size=block_size,
            compat_final_step=compat_final_step, occ_grid=occ_grid,
            occ_scale=occ_scale, skip_blocks=skip_blocks))
    out = torch.cat(outs) if outs else entry.new_zeros((0, 4))
    return out.reshape(ray_shape + (4,))


def march_intensity(volume, rays: RayBatch, windowing_vec4, clip_center,
                    clip_direction, jitter=None,
                    step_count: int = 150) -> torch.Tensor:
    """First-hit windowed-intensity view (`PerformWindowedIntensityRaymarch`,
    usf:187-242) -> (..., 4): the windowed intensity of the first unclipped
    sample as grey, alpha 1 on a hit, else 0. The steps clip and sample at
    the clamped position (usf:213); the final step at the unclamped one."""
    win = _as_device(windowing_vec4, volume)
    cc, cd = _as_device(clip_center, volume), _as_device(clip_direction,
                                                         volume)
    center, width = win[0], win[1]
    st = _march_state(rays, step_count, jitter)
    ray_shape = rays.thickness.shape
    pos = st.pos0
    value = torch.zeros(ray_shape, device=pos.device)
    hit = torch.zeros(ray_shape, dtype=torch.bool, device=pos.device)
    for i in range(_loop_bound(st.n_full, step_count)):
        in_range = i < st.n_full
        pos = torch.where(in_range[..., None], pos + st.step_vec, pos)
        p = pos.clamp(0.0, 1.0)
        active = in_range & ~hit & ~is_clipped(p, cc, cd)
        tf_pos = transfer_func_position(trilinear_sample(volume, p), center,
                                        width).clamp(0.0, 1.0)
        value = torch.where(active, tf_pos, value)
        hit = hit | active

    pos_f = pos + st.step_vec * st.final_frac[..., None]
    active_f = ~hit & (st.final_frac > 0.0) & ~is_clipped(pos_f, cc, cd)
    tf_pos_f = transfer_func_position(trilinear_sample(volume, pos_f), center,
                                      width).clamp(0.0, 1.0)
    value = torch.where(active_f, tf_pos_f, value)
    hit = hit | active_f
    return torch.cat([value[..., None].expand(ray_shape + (3,)),
                      hit.to(torch.float32)[..., None]], -1)
