"""Volume slab sharding along Z: the slab-sharded march, the ray-state
ring and the sharded illumination (forward only).

Counterpart of `tbraymarcherplugin_tpu/parallel/slab_sharding.py`. Every
rank owns the Z slab ``[rank * Z / n, (rank + 1) * Z / n)`` of the volume
on the mesh axis ``"slab"`` (the functions take the global volume and each
rank reads only its slab); the planes a slab's trilinear fetches need
beyond it come from its neighbours as a halo, over
``torch.distributed.batch_isend_irecv`` rings.

- :func:`march_lit_slab_sharded`: every rank marches all rays through its
  slab, accumulating the ray segment inside it; the segments are
  all-gathered and composed in Z order (reversed for rays pointing down
  Z). The over operator is associative, so this is exact without the
  mid-ray alpha snap: early termination is off.
- :func:`march_lit_slab_ring`: the live per-ray state (rgba, terminated)
  hops from slab owner to slab owner in each ray's Z order, so early
  termination is exact (`ops.march.march_lit`'s semantics).
- :func:`compute_illumination_sharded`: the occluder opacity is computed
  slab by slab (from a halo), all-gathered, and each face's scan runs
  replicated (`ops.lighting.scan_one_face`, kernel K4 on the card).
- :func:`compute_illumination_sharded_v2`: no 3D field is gathered: Z
  faces scan as a ring of carries, X and Y faces gather one slice a step;
  every rank returns its own Z chunk. Its scans are plain torch.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.pipeline import LightPlan, RenderParams, _windowing_vec4
from ..ops import lighting as L
from ..ops.compositing import EARLY_TERMINATION_ALPHA, accumulate, compose_segments
from ..ops.light_scan import _alpha_tensor, shift_2d_bilinear_border
from ..ops.march import _as_device, _loop_bound, _march_state
from ..ops.rays import RayBatch
from ..ops.sampling import (
    VOLUME_DENSITY,
    clip_soft_alpha_weight,
    is_clipped,
    sample_windowed_transfer_function,
    trilinear_sample,
)
from ..ops.tf_alpha import windowed_tf_alpha
from .overlap import all_gather_cat


def _axis(mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def _ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``rank + shift`` and return what rank
    ``rank - shift`` sent (ranks modulo the group's size)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _slab(volume: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    z = volume.shape[2] // n
    return volume[:, :, rank * z:(rank + 1) * z]


def _halo_exchange_z(slab: torch.Tensor, group, rank: int, n: int):
    """``slab`` with the next rank's first Z plane appended (the last rank
    repeats its own last plane: clamp-to-edge at the volume's end)."""
    received = _ring_shift(slab[:, :, :1], group, -1)
    halo = slab[:, :, -1:] if rank == n - 1 else received
    return torch.cat([slab, halo], dim=2)


def _trilinear_slab(slab_halo: torch.Tensor, uvw: torch.Tensor, global_dims,
                    z_start: int) -> torch.Tensor:
    """`ops.sampling.trilinear_sample` of the global volume at ``uvw``, read
    from a Z slab starting at plane ``z_start`` (+ halo): the same
    arithmetic, with the Z indices clamped globally and then re-based into
    the slab. Exact where both Z corners lie in the slab and its halo; the
    callers mask the other samples by ownership."""
    dims = torch.tensor(global_dims, dtype=torch.float32, device=uvw.device)
    p = uvw * dims - 0.5
    i0 = torch.floor(p)
    frac = p - i0
    i0 = i0.long()
    z_len = slab_halo.shape[2] - 1
    sy = slab_halo.shape[1] * slab_halo.shape[2]
    sz = slab_halo.shape[2]
    flat = slab_halo.reshape(-1)

    def ax_idx(a, off):
        return (i0[..., a] + off).clamp(0, global_dims[a] - 1)

    def corner(dx, dy, dz):
        iz = (ax_idx(2, dz) - z_start).clamp(0, z_len)
        return flat[ax_idx(0, dx) * sy + ax_idx(1, dy) * sz + iz]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _owned(pos_z: torch.Tensor, z_dim: int, z_start: int, z_count: int):
    iz = torch.clamp(torch.floor(pos_z * z_dim - 0.5), 0, z_dim - 1)
    return (iz >= z_start) & (iz < z_start + z_count)


def _slab_march(slab_halo, z_start: int, z_count: int, global_dims, tf_table,
                light_volume, rays: RayBatch, win, cc, cd, energy,
                terminated, class_mask, step_count: int,
                early_termination: float, compat_final_step: bool,
                jitter=None):
    """One slab's turn: march the carried (energy, terminated) of the rays
    in ``class_mask`` through the samples this slab owns, with
    `ops.march.march_lit`'s step loop, snap and final step (the final
    fractional step is applied by the slab that owns its position, the
    last one the ray visits)."""
    st = _march_state(rays, step_count, jitter)
    step_world = VOLUME_DENSITY * st.step_size

    def owned(pos):
        return _owned(pos[..., 2], global_dims[2], z_start, z_count)

    def sample(pos, step_sz):
        rgba = sample_windowed_transfer_function(
            _trilinear_slab(slab_halo, pos, global_dims, z_start), step_sz,
            tf_table, win)
        light = trilinear_sample(light_volume, pos.clamp(0.0, 1.0))
        return torch.cat([rgba[..., :3] * light[..., None], rgba[..., 3:]],
                         -1)

    pos = st.pos0
    for i in range(_loop_bound(st.n_full, step_count)):
        in_range = i < st.n_full
        pos = torch.where(in_range[..., None], pos + st.step_vec, pos)
        active = (class_mask & in_range & ~terminated
                  & ~is_clipped(pos, cc, cd) & owned(pos))
        energy = torch.where(active[..., None],
                             accumulate(energy, sample(pos, step_world)),
                             energy)
        hit = active & (energy[..., 3] > early_termination)
        energy = torch.cat([energy[..., :3], torch.where(
            hit, torch.ones_like(energy[..., 3]), energy[..., 3])[..., None]],
            -1)
        terminated = terminated | hit
    pos_f = pos + st.step_vec * st.final_frac[..., None]
    active_f = (class_mask & ~terminated & (st.final_frac > 0.0)
                & owned(pos_f) & ~is_clipped(pos_f, cc, cd))
    fs_world = (VOLUME_DENSITY * st.final_frac if compat_final_step
                else VOLUME_DENSITY * st.step_size * st.final_frac)
    energy = torch.where(active_f[..., None],
                         accumulate(energy, sample(pos_f, fs_world)), energy)
    return energy, terminated


def _flat(rays: RayBatch) -> RayBatch:
    return RayBatch(rays.entry.reshape(-1, 3), rays.direction.reshape(-1, 3),
                    rays.thickness.reshape(-1))


def _z_split(volume, n: int):
    dims = tuple(int(d) for d in volume.shape)
    if dims[2] % n:
        raise ValueError(f"Z = {dims[2]} must divide the slab axis ({n})")
    return dims, dims[2] // n


@torch.no_grad()
def march_lit_slab_sharded(mesh, volume, tf_table, light_volume,
                           rays: RayBatch, windowing_vec4, clip_center,
                           clip_direction, step_count: int = 150,
                           axis: str = "slab",
                           compat_final_step: bool = True) -> torch.Tensor:
    """Slab-sharded lit march -> (..., 4) on every rank, equal to
    `ops.march.march_lit` with early termination off (see the module
    docstring). ``volume`` is the global (X, Y, Z) volume; each rank reads
    its Z slab; ``rays`` are replicated."""
    group, n, rank = _axis(mesh, axis)
    dims, z_count = _z_split(volume, n)
    flat = _flat(rays)
    win = _as_device(windowing_vec4, volume)
    cc, cd = _as_device(clip_center, volume), _as_device(clip_direction,
                                                         volume)
    slab_halo = _halo_exchange_z(_slab(volume, rank, n), group, rank, n)
    m = flat.thickness.shape[0]
    seg, _ = _slab_march(
        slab_halo, rank * z_count, z_count, dims, tf_table, light_volume,
        flat, win, cc, cd, volume.new_zeros((m, 4)),
        torch.zeros(m, dtype=torch.bool, device=volume.device),
        torch.ones(m, dtype=torch.bool, device=volume.device), step_count,
        math.inf, compat_final_step)
    segs = all_gather_cat(seg[None], 0, group)  # (n, N, 4), Z order
    fwd = (flat.direction[..., 2] >= 0.0)[..., None]
    energy = torch.zeros_like(seg)
    for i in range(n):
        energy = compose_segments(
            energy, torch.where(fwd, segs[i], segs[n - 1 - i]))
    return energy.reshape(*rays.thickness.shape, 4)


@torch.no_grad()
def march_lit_slab_ring(mesh, volume, tf_table, light_volume, rays: RayBatch,
                        windowing_vec4, clip_center, clip_direction,
                        step_count: int = 150,
                        early_termination: float = EARLY_TERMINATION_ALPHA,
                        axis: str = "slab", compat_final_step: bool = True,
                        jitter=None) -> torch.Tensor:
    """Slab-sharded lit march with early termination: the ray-state ring.

    The per-ray carry (rgba, terminated) hops between slab owners in each
    ray's Z order: rays pointing +Z ride the ring 0 -> 1 -> ... -> n-1,
    rays pointing -Z ride it back, so with two slabs both ranks march on
    every turn. A hop moves 17 bytes a ray (the flag as uint8). The
    carried alpha crosses slab boundaries, so the 0.95 snap is exact and
    the image equals `ops.march.march_lit`'s. The turns serialize the
    slabs: it is the exact path for volumes too large for one GPU.
    """
    group, n, rank = _axis(mesh, axis)
    dims, z_count = _z_split(volume, n)
    flat = _flat(rays)
    jit = None if jitter is None else _as_device(jitter, volume).reshape(-1)
    win = _as_device(windowing_vec4, volume)
    cc, cd = _as_device(clip_center, volume), _as_device(clip_direction,
                                                         volume)
    slab_halo = _halo_exchange_z(_slab(volume, rank, n), group, rank, n)
    m = flat.thickness.shape[0]
    fwd = flat.direction[..., 2] >= 0.0

    def turn(carry, class_mask):
        return _slab_march(
            slab_halo, rank * z_count, z_count, dims, tf_table, light_volume,
            flat, win, cc, cd, carry[0], carry[1], class_mask, step_count,
            early_termination, compat_final_step, jit)

    def hop(carry, shift):
        energy = _ring_shift(carry[0], group, shift)
        term = _ring_shift(carry[1].to(torch.uint8), group, shift)
        return energy, term.bool()

    zero = (volume.new_zeros((m, 4)),
            torch.zeros(m, dtype=torch.bool, device=volume.device))
    carry_f, carry_b = zero, zero
    for t in range(n):
        if rank == t:
            carry_f = turn(carry_f, fwd)
        if rank == n - 1 - t:
            carry_b = turn(carry_b, ~fwd)
        if t < n - 1:
            carry_f, carry_b = hop(carry_f, 1), hop(carry_b, -1)
    # the +Z rays end on rank n-1, the -Z rays on rank 0: a one-hot
    # all-reduce replicates both (adding zeros is exact)
    e_f = carry_f[0] if rank == n - 1 else torch.zeros_like(carry_f[0])
    e_b = carry_b[0] if rank == 0 else torch.zeros_like(carry_b[0])
    e_f, e_b = e_f.clone(), e_b.clone()
    dist.all_reduce(e_f, group=group)
    dist.all_reduce(e_b, group=group)
    out = torch.where(fwd[..., None], e_f, e_b)
    return out.reshape(*rays.thickness.shape, 4)


def _light_grid(light_dims, z0: int, lz: int, uvw_offset, device):
    """(uvw (LX, LY, lz, 3), resolution) of light voxels z0 .. z0 + lz - 1,
    offset toward the light, as `ops.lighting.occluder_opacity_volume`
    computes them."""
    res = torch.tensor(light_dims, dtype=torch.float32, device=device)
    ranges = [torch.arange(d, dtype=torch.float32, device=device)
              for d in light_dims[:2]]
    ranges.append(torch.arange(lz, dtype=torch.float32, device=device) + z0)
    grids = torch.meshgrid(*ranges, indexing="ij")
    off = torch.as_tensor(np.asarray(uvw_offset, np.float32), device=device)
    return (torch.stack(grids, dim=-1) + 0.5) / res + off, res


def _occluder(value, uvw, res, fp, params, win, cc, cd):
    """The occluder opacity of one face's voxels from their volume values
    (windowed TF alpha, kernel K3 on the card, times the soft clip
    weight; zero where the offset sample leaves the cube)."""
    aw = clip_soft_alpha_weight(uvw, cc, cd, res)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    step = float(np.float32(fp.step_size) * np.float32(VOLUME_DENSITY))
    opacity = windowed_tf_alpha(value.contiguous(), params.tf_table, win,
                                step)
    return torch.where(inside & (aw > 0.0), opacity * aw,
                       torch.zeros_like(opacity))


def _light_split(params: RenderParams, light_dims, n: int):
    ld = tuple(int(d) for d in light_dims)
    vd = tuple(int(d) for d in params.volume.shape)
    if ld[2] % n or vd[2] % n:
        raise ValueError(f"light Z {ld[2]} and volume Z {vd[2]} must divide "
                         f"the slab axis ({n})")
    return ld, vd, ld[2] // n, vd[2] // n


def _halo_depth(vd, ld) -> int:
    """The Z halo the constant-shift sampling needs: the largest shift,
    |c_z| <= 0.5 rz - 0.5 + rz ld_z / min(ld), one trilinear corner and
    rz - 1 of stride end."""
    rz = vd[2] // ld[2]
    return int(math.ceil(0.5 * rz - 0.5 + rz * ld[2] / min(ld))) + 1 + (rz - 1)


@torch.no_grad()
def compute_illumination_sharded(mesh, params: RenderParams,
                                 light_plans: Sequence[LightPlan],
                                 clip_center, clip_direction, light_dims,
                                 axis: str = "slab", low_cutoff: bool = True,
                                 high_cutoff: bool = True) -> torch.Tensor:
    """The illumination volume with the occluder-opacity fetches sharded
    along Z -> ``light_dims`` on every rank.

    Each rank evaluates the opacity of its Z slab of the light grid from
    its volume slab and a halo, the slabs are all-gathered, and each
    face's scan runs replicated (K4 on the card). The samples are those of
    `ops.lighting.occluder_opacity_volume`: the constant-shift resample
    where the volume/light ratios are integers and the slab is at least
    the shift's halo deep (``k`` planes each side), else a trilinear fetch
    per voxel from the slab and the next rank's first plane (the JAX
    package's v1 samples per voxel always). Matches
    `models.pipeline.compute_illumination`."""
    group, n, rank = _axis(mesh, axis)
    ld, vd, lz, vz = _light_split(params, light_dims, n)
    win = _windowing_vec4(params, low_cutoff, high_cutoff)
    slab = _slab(params.volume, rank, n)
    k = _halo_depth(vd, ld)
    if all(v % l == 0 for v, l in zip(vd, ld)) and k <= vz:
        slab_halo = _halo_z_k(slab, group, rank, n, k)

        def values(uvw, uvw_offset):
            return _local_const_shift_trilinear(slab_halo, k, vd, ld, lz,
                                                uvw_offset)
    else:
        slab_halo = _halo_exchange_z(slab, group, rank, n)

        def values(uvw, uvw_offset):
            return _trilinear_slab(slab_halo, uvw, vd, rank * vz)
    lv = torch.zeros(ld, dtype=torch.float32, device=params.volume.device)
    for li, plan in enumerate(light_plans):
        for fp in plan.face_plans:
            uvw, res = _light_grid(ld, rank * lz, lz, fp.uvw_offset,
                                   params.volume.device)
            opac = _occluder(values(uvw, fp.uvw_offset), uvw, res, fp,
                             params, win, clip_center, clip_direction)
            lv = lv + L.scan_one_face(
                all_gather_cat(opac, 2, group), fp.uv_offset,
                params.light_intensities[li] * fp.light_alpha, fp.face, ld,
                apply_write_threshold=False)
    return lv


def _halo_z_k(slab: torch.Tensor, group, rank: int, n: int, k: int):
    """``slab`` with ``k`` Z planes of its neighbours on either side (the
    global ends repeat their boundary plane: clamp-to-edge)."""
    recv_lo = _ring_shift(slab[:, :, -k:], group, 1)
    recv_hi = _ring_shift(slab[:, :, :k], group, -1)
    lo = slab[:, :, :1].expand(-1, -1, k) if rank == 0 else recv_lo
    hi = slab[:, :, -1:].expand(-1, -1, k) if rank == n - 1 else recv_hi
    return torch.cat([lo, slab, hi], dim=2)


def _local_const_shift_trilinear(slab_halo, k: int, vd, ld, lz: int,
                                 uvw_offset) -> torch.Tensor:
    """The slab's share of `ops.lighting._const_shift_trilinear`: light
    voxel g samples the volume at g * r + c for a constant c per axis.
    ``slab_halo`` is this rank's volume slab with a ``k``-plane halo on
    either side; light and volume slabs are aligned, so corner dz of local
    light plane 0 starts at ``k + floor(c_z) + dz`` on every rank. X and Y
    are whole (edge-padded as the single-device path pads them)."""
    r = tuple(v // l for v, l in zip(vd, ld))
    pads = tuple(r[a] + 2 + -(-r[a] * ld[a] // min(ld)) for a in range(3))
    vp = F.pad(slab_halo[None, None],
               (0, 0, pads[1], pads[1], pads[0], pads[0]),
               mode="replicate")[0, 0]
    off = np.asarray(uvw_offset, np.float32)
    i0, frac = [], []
    for a in range(3):
        c = np.float32(0.5 * r[a] - 0.5) + off[a] * np.float32(vd[a])
        f = np.floor(c)
        frac.append(np.float32(c - f))
        base, edge = (pads[a], 2 * pads[a]) if a < 2 else (k, 2 * k)
        i0.append(int(np.clip(int(f) + base, 0, edge + r[a] - 2)))
    counts = (ld[0], ld[1], lz)

    def corner(dx, dy, dz):
        sl = tuple(slice(i + d, i + d + (m - 1) * s + 1, s) for i, d, m, s in
                   zip(i0, (dx, dy, dz), counts, r))
        return vp[sl]

    one = np.float32(1.0)
    gx, gy, gz = (float(one - f) for f in frac)
    fx, fy, fz = (float(f) for f in frac)
    c00 = corner(0, 0, 0) * gz + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * gz + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * gz + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * gz + corner(1, 1, 1) * fz
    c0 = c00 * gy + c01 * fy
    c1 = c10 * gy + c11 * fy
    return c0 * gx + c1 * fx


@torch.no_grad()
def compute_illumination_sharded_v2(mesh, params: RenderParams,
                                    light_plans: Sequence[LightPlan],
                                    clip_center, clip_direction, light_dims,
                                    axis: str = "slab",
                                    low_cutoff: bool = True,
                                    high_cutoff: bool = True) -> torch.Tensor:
    """Fully sharded illumination: no 3D field is gathered. Returns this
    rank's Z chunk of the light volume, (LX, LY, LZ / n); the chunks in
    rank order are `models.pipeline.compute_illumination`'s volume.

    - The occluder field of the rank's light slab comes from its volume
      slab with a ``k``-plane halo (ring exchange, the global ends
      replicated) by the constant-shift sampling; volume and light dims
      must have integer ratios.
    - Z faces scan as a ring: the 2D carry hops owner to owner in
      propagation order (`AddDirLightShader.usf:68-128` lifted to the mesh
      axis).
    - X and Y faces scan their whole axis on every rank, all-gathering
      only the current slice (its Z extent is sharded) each step, and keep
      their own Z chunk.

    The scans are plain torch (the JAX package's are XLA): K4 takes no
    carry in and no gather between slices.
    """
    group, n, rank = _axis(mesh, axis)
    ld, vd, lz, vz = _light_split(params, light_dims, n)
    if any(v % l for v, l in zip(vd, ld)):
        raise ValueError("v2 needs integer volume/light resolution ratios")
    k = _halo_depth(vd, ld)
    if k > vz:
        raise ValueError("Z slab thinner than the occluder-offset halo "
                         "reach; use fewer shards or "
                         "compute_illumination_sharded (v1)")
    dev = params.volume.device
    win = _windowing_vec4(params, low_cutoff, high_cutoff)
    slab_halo = _halo_z_k(_slab(params.volume, rank, n), group, rank, n, k)
    lv_local = torch.zeros((ld[0], ld[1], lz), dtype=torch.float32,
                           device=dev)
    for li, plan in enumerate(light_plans):
        for fp in plan.face_plans:
            uvw, res = _light_grid(ld, rank * lz, lz, fp.uvw_offset, dev)
            value = _local_const_shift_trilinear(slab_halo, k, vd, ld, lz,
                                                 fp.uvw_offset)
            opac = _occluder(value, uvw, res, fp, params, win, clip_center,
                             clip_direction)
            ax = L.transposed_axes(fp.face)
            direction = L.face_direction(fp.face)
            tdims = (ld[ax[0]], ld[ax[1]], ld[ax[2]])
            uv = np.asarray(fp.uv_offset, np.float32)
            off_px = uv[0] * np.float32(tdims[0])
            off_py = uv[1] * np.float32(tdims[1])
            alpha = _alpha_tensor(
                params.light_intensities[li] * fp.light_alpha, dev)
            opac_t = opac.permute(ax)
            if direction == -1:
                opac_t = opac_t.flip(2)
            xs = opac_t.movedim(2, 0)  # scan order

            def update(carry, sl):
                return shift_2d_bilinear_border(carry, off_px, off_py,
                                                alpha) * (1.0 - sl)

            carry = alpha.expand(tdims[0], tdims[1])
            if L.face_axis(fp.face) == 2:
                # a ring along the sharded axis: the carry hops in
                # propagation order, each owner scans its slices
                for t in range(n):
                    if rank == (t if direction == 1 else n - 1 - t):
                        mine = []
                        for sl in xs:
                            carry = update(carry, sl)
                            mine.append(carry)
                        res_t = torch.stack(mine, 2)
                    if t < n - 1:
                        carry = _ring_shift(carry.contiguous(), group,
                                            direction)
            else:
                # the scan axis is whole; buffer dim 1 is the sharded Z
                mine = []
                for sl in xs:
                    carry = update(carry, all_gather_cat(sl, 1, group))
                    mine.append(carry[:, rank * lz:(rank + 1) * lz])
                res_t = torch.stack(mine, 2)
            if direction == -1:
                res_t = res_t.flip(2)
            inv = [0, 0, 0]
            for i, a in enumerate(ax):
                inv[a] = i
            lv_local = lv_local + res_t.permute(inv)
    return lv_local
