"""Gradient all-reduce inside the backward, and the autograd all-gather.

Counterpart of `tbraymarcherplugin_tpu/parallel/overlap.py`.
:func:`psum_cotangent` is the identity in the forward and an all-reduce
of the cotangent over a process group in the backward, placed at a
parameter's point of use: the march's volume/TF/window cotangents are
finished (and reduced) while the illumination's backward still computes,
instead of one bulk all-reduce after the whole backward.

Every use of a leaf must be marked, or none: the sum of the per-use
reduced cotangents is the reduction of the total, but marked and unmarked
uses under an outer all-reduce would reduce twice.
`ray_sharding.make_sharded_train_step` therefore skips its bulk reduce in
overlap mode; in bulk mode it marks the same sites with :data:`LOCAL`,
which reduces nothing, so that both modes add a leaf's per-use cotangents
in one order.

:func:`gather_slabs` is the all-gather the differentiable sharded
shear-warp needs: its backward sums the full cotangent over the group and
keeps this rank's slice (the transpose JAX applies to a tiled
``all_gather`` inside ``shard_map``). It uses only ``all_gather`` and
``all_reduce``, which gloo and NCCL both have.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


# The "group" of a marker that reduces nothing: the cotangent passes as is.
LOCAL = "local"


class _PsumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.group == LOCAL:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum_cotangent(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward all-reduces (sums) the cotangent over the
    process group ``group`` (:data:`LOCAL`: no reduction)."""
    return _PsumCotangent.apply(x, group)


def mark_tree(params, group):
    """:func:`psum_cotangent` on every tensor field of the dataclass
    ``params`` (`models.pipeline.RenderParams`); no-op for ``group=None``."""
    if group is None:
        return params
    return dataclasses.replace(params, **{
        f.name: psum_cotangent(getattr(params, f.name), group)
        for f in dataclasses.fields(params)
        if isinstance(getattr(params, f.name), torch.Tensor)})


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors ``x``, concatenated along ``dim`` in rank order
    (every rank's ``x`` has the same shape)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


def gather_slabs(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable tiled all-gather along ``dim`` over ``group``; the
    backward reduce-scatters (all-reduce, then this rank's slice)."""
    return _GatherSlabs.apply(x, dim, group)
