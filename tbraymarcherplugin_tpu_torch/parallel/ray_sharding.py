"""Ray-tile data parallelism: the flat ray batch is split over the mesh's
``"rays"`` axis, the volume is replicated, and parameter gradients are
all-reduced.

Counterpart of `tbraymarcherplugin_tpu/parallel/ray_sharding.py`. Every
rank is handed the same global inputs and works on its block of the
padded flat rays; `shard_map`'s sharded output becomes an all-gather.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..models.pipeline import RenderParams, render_lit_scene
from ..ops.rays import RayBatch
from .overlap import LOCAL, all_gather_cat


def pad_rays_for_mesh(rays: RayBatch, n_shards: int) -> tuple[RayBatch, int]:
    """Rays flattened to (N, ...) and zero-padded to a multiple of
    ``n_shards``, and N. Padded rays have thickness 0 (they march no step
    and render transparent black) and direction 1.0 (no 0/0 in the box
    test)."""
    entry = rays.entry.reshape(-1, 3)
    direction = rays.direction.reshape(-1, 3)
    thickness = rays.thickness.reshape(-1)
    n = thickness.shape[0]
    rem = (-n) % n_shards
    if rem:
        entry = torch.cat([entry, entry.new_zeros((rem, 3))])
        direction = torch.cat([direction, direction.new_ones((rem, 3))])
        thickness = torch.cat([thickness, thickness.new_zeros(rem)])
    return RayBatch(entry, direction, thickness), n


def unpad_image(flat: torch.Tensor, n: int, shape) -> torch.Tensor:
    return flat[:n].reshape(*shape, 4)


def _tile(x: torch.Tensor, rank: int, n_shards: int) -> torch.Tensor:
    per = x.shape[0] // n_shards
    return x[rank * per:(rank + 1) * per]


@torch.no_grad()
def render_lit_sharded(mesh, params: RenderParams, rays: RayBatch,
                       clip_center, clip_direction, light_plans, light_dims,
                       step_count: int = 150,
                       axis: str = "rays") -> torch.Tensor:
    """Sharded forward render; ``rays`` may be (H, W)-shaped, the result is
    (H, W, 4) on every rank. The illumination volume is computed on every
    rank (it is the same for every ray tile, and recomputing it beats
    sending it)."""
    group = mesh.get_group(axis)
    n_shards, rank = dist.get_world_size(group), mesh.get_local_rank(axis)
    img_shape = rays.thickness.shape
    flat, n = pad_rays_for_mesh(rays, n_shards)
    tile = RayBatch(*(_tile(x, rank, n_shards) for x in flat))
    out = render_lit_scene(params, tile, clip_center, clip_direction,
                           tuple(light_plans), tuple(light_dims),
                           step_count=step_count)
    return unpad_image(all_gather_cat(out, 0, group), n, img_shape)


def adam(leaves) -> torch.optim.Optimizer:
    """The default optimizer: Adam at 1e-2 with optax's defaults."""
    return torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


FIELDS = tuple(f.name for f in dataclasses.fields(RenderParams))


def make_sharded_train_step(mesh, loss_from_image: Callable, clip_center,
                            clip_direction, light_plans, light_dims,
                            step_count: int = 64, axis: str = "rays",
                            optimizer: Callable | None = None,
                            overlap_allreduce: bool = False):
    """A data-parallel train step over the mesh axis ``axis``.

    Returns ``(step, make_optimizer)``: ``make_optimizer(leaves)`` builds
    the optimizer (``optimizer``, a factory from the parameter tensors to
    a `torch.optim.Optimizer`; default :func:`adam`), and ``step(params,
    opt, rays_flat, target_flat) -> loss`` renders this rank's block of
    ``rays_flat`` (its leading dim a multiple of the axis size, as
    `pad_rays_for_mesh` gives it), sums ``loss_from_image(image, target)``
    over the block, runs the backward, all-reduces the gradients, steps
    ``opt`` (the leaves of ``params`` change in place) and returns the
    global loss, all-reduced.

    ``overlap_allreduce=False`` all-reduces each leaf's gradient after the
    backward. ``True`` reduces each cotangent inside the backward where it
    is finished (`overlap.psum_cotangent` at the use sites of
    `render_lit_scene`): the march's volume/TF/window cotangents reduce
    while the illumination's backward still computes. The bulk mode marks
    the same use sites without reducing (`overlap.LOCAL`), so both modes
    add a leaf's per-use cotangents in one order and differ only in where
    the sum over ranks falls: at world 1 they give the same bits.
    """
    group = mesh.get_group(axis)
    n_shards, rank = dist.get_world_size(group), mesh.get_local_rank(axis)

    def step(params: RenderParams, opt, rays_flat: RayBatch, target_flat):
        tile = RayBatch(*(_tile(x, rank, n_shards) for x in rays_flat))
        opt.zero_grad(set_to_none=True)
        img = render_lit_scene(
            params, tile, clip_center, clip_direction, tuple(light_plans),
            tuple(light_dims), step_count=step_count,
            grad_allreduce_axis=group if overlap_allreduce else LOCAL)
        # a sum over the block: the sum over ranks is the global loss
        loss = loss_from_image(img, _tile(target_flat, rank, n_shards))
        loss.backward()
        if not overlap_allreduce:
            for f in FIELDS:
                leaf = getattr(params, f)
                if leaf.grad is not None:
                    leaf.grad = leaf.grad.contiguous()
                    dist.all_reduce(leaf.grad, group=group)
        opt.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return loss

    return step, optimizer or adam
