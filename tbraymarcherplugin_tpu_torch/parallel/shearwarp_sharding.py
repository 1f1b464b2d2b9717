"""Multi-GPU shear-warp: data parallelism over the intermediate image's
columns, and the lit frame of a volume sharded in Z slabs.

Counterpart of `tbraymarcherplugin_tpu/parallel/shearwarp_sharding.py`.
The shear-warp composite is independent per intermediate ray, so the
intermediate grid's second axis (n2) is split over the mesh axis: every
rank composites its column slab against the replicated volume (the slab's
plan is :func:`_local_plan`'s, no communication during the composite),
one all-gather assembles the (4, n1, n2) intermediate image (16 bytes a
pixel), and every rank warps the whole image to the screen.

:func:`shearwarp_lit_sharded` is the forward through the dense composite;
:func:`shearwarp_lit_sharded_diff` the differentiable one through the
fused composite (K1, backward K5) and the banded warp (K2, backward K6),
with one all-reduce of the loss and of the gradients.

:func:`shearwarp_lit_slab_sharded` is the frame of a `Renderer` that
holds only its Z slab: no rank can pre-shear a whole plane, so each
pre-shears its slab's share of every plane (partial sums), a
reduce-scatter gives each rank every plane of its own column band whole
in depth, K1 composites the band (every intermediate ray whole on one
rank: early termination, the jitter and the tile bounds as on one card),
and rank 0 gathers the bands and warps (K2).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops import composite as C
from ..ops import shearwarp as SW
from ..ops.compositing import EARLY_TERMINATION_ALPHA
from ..ops.shearwarp_grad import shearwarp_intermediate_fused_diff
from ..ops.warp import warp_to_screen_fused
from ..utils.profiling import BAND_GATHER, PLANE_EXCHANGE, PRESHEAR, span
from .overlap import all_gather_cat, gather_slabs


def _local_plan(plan: SW.ShearWarpPlan, rank: int,
                n2_local: int) -> SW.ShearWarpPlan:
    """The plan of rank ``rank``'s column slab: the grid's columns
    ``rank * n2_local`` onward (`ShearWarpPlan.j0`).

    The JAX package re-bases a2, la2 and o2 to the slab's first column in
    float32; a sample coordinate then differs from the full grid's by an
    ulp, which moves samples and can flip a pixel's 0.95 snap. The port
    evaluates each column's coordinates at its index in the full grid
    instead, so the slabs are the full composite's columns (K1's and K5's
    in-cube test reads the re-based a2, `ops.shearwarp.rebased_columns`,
    whose values are the JAX package's)."""
    return dataclasses.replace(plan, n2=n2_local,
                               j0=plan.j0 + rank * n2_local)


def _slabs(mesh, axis: str, plan: SW.ShearWarpPlan):
    """(group, world, rank, n2_local) of the axis; n2 must split evenly."""
    group = mesh.get_group(axis)
    world, rank = dist.get_world_size(group), mesh.get_local_rank(axis)
    if plan.n2 % world:
        raise ValueError(f"intermediate width {plan.n2} not divisible by "
                         f"{world} devices")
    return group, world, rank, plan.n2 // world


def shearwarp_slab(volume, tf_table, light_volume, plan: SW.ShearWarpPlan,
                   rank: int, world: int, windowing_vec4, clip_center,
                   clip_direction,
                   early_termination: float = EARLY_TERMINATION_ALPHA,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """Rank ``rank``'s share of a ``world``-way split: its column slab of
    the differentiable fused composite, (4, n1, n2 / world). This is all
    of a rank's work before the gather, so one GPU can run the ranks of a
    split in turn."""
    if plan.n2 % world:
        raise ValueError(f"intermediate width {plan.n2} not divisible by "
                         f"{world} devices")
    return shearwarp_intermediate_fused_diff(
        volume, tf_table, light_volume,
        _local_plan(plan, rank, plan.n2 // world), windowing_vec4,
        clip_center, clip_direction, early_termination, compute_dtype)


@torch.no_grad()
def shearwarp_lit_sharded(mesh, volume, tf_table, light_volume,
                          plan: SW.ShearWarpPlan, windowing_vec4,
                          clip_center, clip_direction, width: int,
                          height: int, axis: str = "rays",
                          block_size: int = 16,
                          early_termination: float = EARLY_TERMINATION_ALPHA,
                          stop_early: bool = False,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Sharded shear-warp lit render -> (height, width, 4) on every rank,
    equal to `ops.shearwarp.shearwarp_lit` (each column slab's dense
    composite is independent; every rank warps the gathered image, so the
    frame needs no second gather)."""
    group, _, rank, n2_local = _slabs(mesh, axis, plan)
    inter_local = SW.shearwarp_intermediate(
        volume, tf_table, light_volume, _local_plan(plan, rank, n2_local),
        windowing_vec4, clip_center, clip_direction, block_size=block_size,
        early_termination=early_termination, stop_early=stop_early,
        compute_dtype=compute_dtype)  # (n1, n2_local, 4)
    inter = all_gather_cat(inter_local, 1, group)
    return SW.warp_to_screen(inter, plan, width, height)


def shearwarp_lit_sharded_diff(mesh, volume, tf_table, light_volume,
                               plan: SW.ShearWarpPlan, windowing_vec4,
                               clip_center, clip_direction, width: int,
                               height: int, target=None, axis: str = "rays",
                               early_termination: float = EARLY_TERMINATION_ALPHA,
                               compute_dtype=torch.float32):
    """The differentiable sharded shear-warp.

    Every rank composites its column slab (:func:`shearwarp_slab`: K1,
    backward K5), the slabs are gathered along n2 (`overlap.gather_slabs`,
    whose backward reduce-scatters the cotangent) and every rank warps the
    whole image (K2, backward K6).

    With ``target=None``: the (height, width, 4) frame on every rank.
    With a (height, width, 4) ``target``: ``(loss, (dvolume, dtf,
    dwindow))`` of the summed L2 loss, on every rank. Each rank's loss
    covers its block of ceil(height / world) screen rows, so the rows
    partition the image; loss and gradients are all-reduced once. They
    equal the single-device fused path's, up to the order of the sums
    over ranks.
    """
    group, world, rank, _ = _slabs(mesh, axis, plan)
    win = torch.as_tensor(windowing_vec4, dtype=torch.float32,
                          device=volume.device)

    def render(v, t, w):
        inter = gather_slabs(
            shearwarp_slab(v, t, light_volume, plan, rank, world, w,
                           clip_center, clip_direction, early_termination,
                           compute_dtype), 2, group)  # (4, n1, n2)
        return warp_to_screen_fused(inter, plan, width, height)

    if target is None:
        with torch.no_grad():
            return render(volume, tf_table, win)
    leaves = tuple(x.detach().requires_grad_()
                   for x in (volume, tf_table, win))
    img = render(*leaves)
    rows = -(-height // world)
    own = slice(rank * rows, min((rank + 1) * rows, height))
    target = torch.as_tensor(target, dtype=torch.float32, device=img.device)
    loss = ((img[own] - target[own]) ** 2).sum()
    grads = tuple(g.contiguous() for g in torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    for x in (loss, *grads):  # one data-parallel exchange
        dist.all_reduce(x, group=group)
    return loss, grads


def _reduce_scatter(parts: torch.Tensor, group) -> torch.Tensor:
    """Rank r's sum over the group of ``parts[r]`` ((n, ...) chunks)."""
    out = torch.empty_like(parts[0])
    if dist.get_backend(group) == "gloo":  # gloo has no reduce-scatter
        parts = parts.clone()
        dist.all_reduce(parts, group=group)
        return parts[dist.get_rank(group)].clone()
    dist.reduce_scatter_tensor(out, parts, group=group)
    return out


@torch.no_grad()
def shearwarp_lit_slab_sharded(mesh, volume, tf_table, light_volume,
                               plan: SW.ShearWarpPlan, dims, light_dims,
                               windowing_vec4, clip_center, clip_direction,
                               width: int, height: int, axis: str = "slab",
                               early_termination: float = EARLY_TERMINATION_ALPHA,
                               jitter=None, depth_lam=None,
                               compute_dtype=None):
    """The lit shear-warp frame of a volume of ``dims`` sharded in Z slabs
    over the mesh axis: ``volume`` is this rank's slab (X, Y, Z / n) and
    ``light_volume`` its light chunk; ``plan`` (of the whole volume),
    ``jitter`` and ``depth_lam`` the whole grid's. A collective: the
    (height, width, 4) frame on the axis's rank 0, None on the others.

    1. Each rank pre-shears its slab's share of every plane
       (`composite.preshear_slab`, float32 partial sums: a sample that
       straddles a slab boundary splits its taps between the two ranks).
    2. A reduce-scatter over the intermediate image's column bands (span
       ``tbr.plane_exchange``) gives each rank every plane of its band,
       whole in depth, then stored in the plane type (``compute_dtype``,
       `shearwarp.plane_dtype`'s default); the planes' value ranges (the
       chunk occupancy) are reduced with them.
    3. K1 composites the band through its column-band plan
       (:func:`_local_plan`), the one-card composite's semantics.
    4. Rank 0 gathers the (4, n1, n2 / n) bands (span ``tbr.band_gather``)
       and warps them (K2).

    The planes differ from the one-card pre-shear only in the order of
    their sums and their rounding (float32 partial sums rounded once to
    the plane type, where one card rounds the matmuls' operands)."""
    group, n, rank = (mesh.get_group(axis), dist.get_world_size(
        mesh.get_group(axis)), mesh.get_local_rank(axis))
    if plan.n2 % n:
        raise ValueError(f"intermediate width {plan.n2} not divisible by "
                         f"{n} devices")
    nb = plan.n2 // n
    dims = tuple(int(d) for d in dims)
    light_dims = tuple(int(d) for d in light_dims)
    z0 = rank * (dims[2] // n)
    lz0 = rank * (light_dims[2] // n)
    dtype = SW.plane_dtype(compute_dtype, volume.device)
    with span(PRESHEAR):
        W, L, (mn, mx) = C.preshear_slab(volume, light_volume, plan, dims,
                                         light_dims, z0, lz0, n,
                                         jitter is not None)
    sent = 2 * (n - 1) * W[0].numel() * W.element_size()
    with span(PLANE_EXCHANGE, f"bytes={sent}"):
        W = _reduce_scatter(W, group).to(dtype)
        L = _reduce_scatter(L, group).to(dtype)
        rng = torch.stack([-mn, mx])
        dist.all_reduce(rng, op=dist.ReduceOp.MAX, group=group)
    band = _local_plan(plan, rank, nb)
    cols = slice(rank * nb, (rank + 1) * nb)
    ops = C.composite_args(
        band, W, L, tf_table, windowing_vec4, (-rng[0], rng[1]),
        clip_center, clip_direction, early_termination,
        None if jitter is None else jitter[:, cols],
        None if depth_lam is None else torch.as_tensor(depth_lam)[:, cols],
        "lit", dims[plan.axes12[0]], dims[plan.axes12[1]])
    inter = C.composite(**ops)  # (4, n1, nb)
    root = dist.get_global_rank(group, 0)
    with span(BAND_GATHER,
              f"bytes={0 if rank == 0 else inter.numel() * 4}"):
        parts = ([torch.empty_like(inter) for _ in range(n)]
                 if rank == 0 else None)
        dist.gather(inter, parts, dst=root, group=group)
    if rank != 0:
        return None
    return warp_to_screen_fused(torch.cat(parts, dim=2), plan, width,
                                height)
