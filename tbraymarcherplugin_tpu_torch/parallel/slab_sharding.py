"""Volume slab sharding along Z: the slab-sharded march, the ray-state
ring and the sharded illumination (forward only).

Counterpart of `tbraymarcherplugin_tpu/parallel/slab_sharding.py`. Every
rank owns the Z slab ``[rank * Z / n, (rank + 1) * Z / n)`` of the volume
on the mesh axis ``"slab"`` (the marches take the global volume and each
rank reads only its slab; the rebuild takes the rank's slab alone); the
planes a slab's trilinear fetches need
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
- :func:`compute_illumination_sharded_v2`: slab-local, from the rank's
  own slab (:func:`hold_slab` keeps its halo): K3 on the slab, the Z
  faces' K4 as a ring of carries, the X and Y faces' K4 in chunks with a
  light halo exchanged between them; every rank returns its own Z chunk.
  The sharded `Renderer` rebuilds through it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.pipeline import LightPlan, RenderParams, _windowing_vec4
from ..ops import lighting as L
from ..ops.compositing import EARLY_TERMINATION_ALPHA, accumulate, compose_segments
from ..ops.light_scan import _split_offset, propagate_face_scan
from ..ops.march import _as_device, _loop_bound, _march_state
from ..ops.rays import RayBatch
from ..ops.sampling import (
    VOLUME_DENSITY,
    is_clipped,
    sample_windowed_transfer_function,
    trilinear_sample,
)
from ..utils.profiling import (HALO, LIGHT_HALO, LIGHT_RING, LIGHT_SCAN,
                               OCCLUDER, span)
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


def _halo_depth(vd, ld) -> int:
    """The Z halo an occluder sample at a face's offset reads beyond the
    light planes it is for: the largest shift,
    |c_z| <= 0.5 rz - 0.5 + rz ld_z / min(ld), one trilinear corner and
    rz - 1 of stride end."""
    rz = vd[2] // ld[2]
    return int(math.ceil(0.5 * rz - 0.5 + rz * ld[2] / min(ld))) + 1 + (rz - 1)


# X and Y faces: K4 runs on chunks of at most this many slices; before
# each chunk, the columns that the per-slice shift carries across a slab
# boundary come from the ranks that own them, for a halo as wide as the
# chunk's slices times the shift's reach (PERF.md: the choice and the
# exchanges it costs)
LIGHT_HALO_SLICES = 16
# slices of a scanned chunk thresholded and added at a time
_ADD_SLICES = 64


class HeldSlab(NamedTuple):
    """A rank's Z slab [z0, z1) of a volume of ``dims`` and the halo
    planes it holds: ``data`` is (X, Y, lo + (z1 - z0) + hi) float32,
    contiguous; each side's halo is ``depth`` planes, cut at the
    volume's ends."""

    data: torch.Tensor
    z0: int
    z1: int
    lo: int
    hi: int
    depth: int
    dims: tuple

    @property
    def slab(self) -> torch.Tensor:
        """The slab itself, (X, Y, z1 - z0): a view of ``data``."""
        return self.data[:, :, self.lo:self.lo + self.z1 - self.z0]

    @property
    def held_z0(self) -> int:
        """The global Z of ``data``'s first plane."""
        return self.z0 - self.lo


def z_ranges(total: int, n: int) -> list:
    """Each rank's [z0, z1) of ``total`` Z planes split ``n`` ways."""
    return [(r * total // n, (r + 1) * total // n) for r in range(n)]


def _gather_planes(local: torch.Tensor, own: list, wants: list, group,
                   rank: int, name: str, args: str = ""):
    """The planes ``wants[rank]`` = [a, b) along the last dim, from the
    ranks that own them, where rank q holds the planes ``own[q]`` (this
    rank's in ``local``) and wants the planes ``wants[q]``: one
    ``batch_isend_irecv`` in which each rank sends every other the part of
    its planes that rank wants, in a span ``name`` whose args end in the
    bytes this rank sent."""
    a, b = wants[rank]
    o0, o1 = own[rank]
    sends, recvs = [], []
    for q, ((w0, w1), (q0, q1)) in enumerate(zip(wants, own)):
        if q == rank:
            continue
        lo, hi = max(w0, o0), min(w1, o1)
        if lo < hi:
            sends.append((q, lo - o0, hi - o0))
        lo, hi = max(a, q0), min(b, q1)
        if lo < hi:
            recvs.append((q, lo - a, hi - lo))
    plane = local[..., :1].numel() * local.element_size()
    sent = sum(hi - lo for _, lo, hi in sends) * plane
    out = local.new_empty(local.shape[:-1] + (max(b - a, 0),))
    with span(name, f"{args}bytes={sent}"):
        ops, bufs = [], []
        for q, lo, hi in sends:
            ops.append(dist.P2POp(dist.isend,
                                  local[..., lo:hi].contiguous(),
                                  dist.get_global_rank(group, q), group))
        for q, at, m in recvs:
            buf = out.new_empty(out.shape[:-1] + (m,))
            bufs.append((at, buf))
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, q), group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for at, buf in bufs:
            out[..., at:at + buf.shape[-1]] = buf
    return out


@torch.no_grad()
def hold_slab(mesh, slab: torch.Tensor, dims, depth: int,
              axis: str = "slab") -> HeldSlab:
    """This rank's Z slab (X, Y, Z / n) of a volume of ``dims`` with
    ``depth`` planes of the other ranks' on either side (fewer at the
    volume's ends), exchanged once (span ``tbr.halo``); a collective of
    the mesh axis. Refuses a slab of another shape."""
    group, n, rank = _axis(mesh, axis)
    dims = tuple(int(d) for d in dims)
    if dims[2] % n:
        raise ValueError(f"Z = {dims[2]} must divide the slab axis ({n})")
    own = z_ranges(dims[2], n)
    z0, z1 = own[rank]
    if tuple(slab.shape) != (dims[0], dims[1], z1 - z0):
        raise ValueError(
            f"rank {rank} of {n} holds Z planes {z0}..{z1 - 1} of a "
            f"{dims} volume: a slab of {(dims[0], dims[1], z1 - z0)}, got "
            f"{tuple(slab.shape)}")
    depth = int(depth)
    below = _gather_planes(slab, own, [(max(q0 - depth, 0), q0)
                                       for q0, _ in own], group, rank, HALO)
    above = _gather_planes(slab, own, [(q1, min(q1 + depth, dims[2]))
                                       for _, q1 in own], group, rank, HALO)
    data = torch.cat([below, slab, above], dim=2).contiguous()
    return HeldSlab(data, z0, z1, below.shape[2], above.shape[2], depth,
                    dims)


def _xy_face_halo(fp, light_dims, zc: int) -> tuple:
    """(slices a chunk, halo columns, halo above) of the X or Y face plan
    ``fp`` on light chunks of ``zc`` columns: the columns (Z) its
    per-slice shift reads lie on one side, ``reach`` of them a slice; a
    chunk of h slices (at most :data:`LIGHT_HALO_SLICES`, and a halo at
    most half a chunk's columns where a slice reaches fewer) reads a halo
    of h * reach columns (rounded up to 4, so that K4 keeps its units of
    4 pixels)."""
    tdims = tuple(light_dims[a] for a in L.transposed_axes(fp.face))
    iy, _ = _split_offset(np.float32(fp.uv_offset[1])
                          * np.float32(tdims[1]))
    reach = iy + 1 if iy >= 0 else -iy
    h = min(LIGHT_HALO_SLICES, tdims[2], max(1, zc // 2 // reach))
    return h, -(-h * reach // 4) * 4, iy >= 0


def held_depth(light_plans, volume_dims, light_dims, n: int) -> int:
    """The volume halo a rank must hold for the rebuild of
    ``light_plans``: the occluder's sample offset (:func:`_halo_depth`),
    and for an X or Y face its chunks' light halo (:func:`_xy_face_halo`)
    in volume planes."""
    vd = tuple(int(d) for d in volume_dims)
    ld = tuple(int(d) for d in light_dims)
    k = _halo_depth(vd, ld)
    depth = k
    for plan in light_plans:
        for fp in plan.face_plans:
            if L.face_axis(fp.face) != 2:
                _, cols, _ = _xy_face_halo(fp, ld, ld[2] // n)
                depth = max(depth, k + cols * (vd[2] // ld[2]))
    return depth


def _add_thresholded(target_view, res, apply_write_threshold: bool,
                     reverse: bool = False):
    """``target_view += res`` (``res`` reversed along dim 0 with
    ``reverse``), the write threshold applied to ``res``
    (`ops.lighting.scan_one_face`'s), a few slices at a time so that the
    temporaries stay small; both are indexed by slices along dim 0."""
    n = res.shape[0]
    for a in range(0, n, _ADD_SLICES):
        r = res[a:a + _ADD_SLICES]
        if apply_write_threshold:
            r = torch.where(r.abs() > L.WRITE_SKIP_THRESHOLD, r,
                            torch.zeros_like(r))
        if reverse:
            target_view[n - a - r.shape[0]:n - a] += r.flip(0)
        else:
            target_view[a:a + r.shape[0]] += r


def _z_face(ctx, fp, alpha: float, target):
    """One Z face of one light into ``target``, this rank's light chunk:
    K3 on the rank's slab, then K4 on its chunk with the light entering
    it from the upstream rank, whose carry out hops on (the ring, span
    ``tbr.light_ring``)."""
    group, n, rank = ctx.group, ctx.n, ctx.rank
    direction = L.face_direction(fp.face)
    with span(OCCLUDER):
        opac = L.occluder_opacity(
            ctx.held.data, ctx.tf_table, ctx.win, ctx.ld, fp.uvw_offset,
            fp.step_size, ctx.cc, ctx.cd, window=ctx.window(*ctx.lz))
    with span(LIGHT_SCAN, fp.face):
        tdims = ctx.ld
        uv = np.asarray(fp.uv_offset, np.float32)
        off_px = uv[0] * np.float32(tdims[0])
        off_py = uv[1] * np.float32(tdims[1])
        if direction == -1:
            opac = opac.flip(2)
        scan = opac.movedim(2, 0).contiguous()
        del opac
        up, down = rank - direction, rank + direction
        plane = scan[0].numel() * scan.element_size()
        carry = None
        if 0 <= up < n:
            with span(LIGHT_RING, f"face={fp.face} bytes=0"):
                carry = scan.new_empty(scan.shape[1:])
                dist.recv(carry, dist.get_global_rank(group, up), group)
                if carry.is_cuda:  # the wait for the upstream ranks
                    torch.cuda.current_stream(carry.device).synchronize()
        res = propagate_face_scan(scan, off_px, off_py, alpha, carry)
        del scan
        if 0 <= down < n:
            with span(LIGHT_RING, f"face={fp.face} bytes={plane}"):
                dist.send(res[-1].contiguous(),
                          dist.get_global_rank(group, down), group)
        _add_thresholded(target.permute(2, 0, 1), res, ctx.threshold,
                         reverse=direction == -1)


def _xy_face(ctx, fp, alpha: float, target):
    """One X or Y face of one light into ``target``: the scan axis (X or
    Y) is whole on every rank and the columns (Z) are sharded, so each
    rank scans its own Z band of every slice, in chunks of slices whose
    light halo (the columns the shift carries in from the other ranks'
    bands) is exchanged before each chunk (span ``tbr.light_halo``) and
    computed again by the rank itself within the chunk, from the halo's
    occluder field (K3 on the held volume halo)."""
    group, rank = ctx.group, ctx.rank
    face = fp.face
    ax = L.transposed_axes(face)
    tdims = tuple(ctx.ld[a] for a in ax)
    uv = np.asarray(fp.uv_offset, np.float32)
    off_px = uv[0] * np.float32(tdims[0])
    off_py = uv[1] * np.float32(tdims[1])
    h, cols, above = _xy_face_halo(fp, ctx.ld, ctx.lz[1] - ctx.lz[0])
    z0, z1 = ctx.lz
    LZ = ctx.ld[2]
    own = z_ranges(LZ, ctx.n)
    if above:
        ext = (z0, min(z1 + cols, LZ))
        wants = [(q1, min(q1 + cols, LZ)) for _, q1 in own]
    else:
        ext = (max(z0 - cols, 0), z1)
        wants = [(max(q0 - cols, 0), q0) for q0, _ in own]
    at = z0 - ext[0]  # the own columns' first in the band
    zc = z1 - z0
    with span(OCCLUDER):
        opac = L.occluder_opacity(
            ctx.held.data, ctx.tf_table, ctx.win, ctx.ld, fp.uvw_offset,
            fp.step_size, ctx.cc, ctx.cd, window=ctx.window(*ext))
    with span(LIGHT_SCAN, face):
        # scan order (K, H, W): the scan axis, the other of X and Y, Z
        scan = opac if L.face_axis(face) == 0 else opac.permute(1, 0, 2)
        view = target if L.face_axis(face) == 0 else target.permute(1, 0, 2)
        if L.face_direction(face) == -1:
            scan = scan.flip(0)
        scan = scan.contiguous()
        del opac
        K = scan.shape[0]
        carry = None
        for k0 in range(0, K, h):
            res = propagate_face_scan(scan[k0:k0 + h], off_px, off_py,
                                      alpha, carry)
            mine = res[:, :, at:at + zc]
            if k0 + h < K:
                halo = _gather_planes(res[-1, :, at:at + zc], own, wants,
                                      group, rank, LIGHT_HALO,
                                      f"face={face} ")
                carry = torch.empty_like(res[-1])
                carry[:, at:at + zc] = mine[-1]
                w0 = wants[rank][0] - ext[0]
                carry[:, w0:w0 + halo.shape[1]] = halo
            if L.face_direction(face) == -1:
                _add_thresholded(view[K - k0 - mine.shape[0]:K - k0], mine,
                                 ctx.threshold, reverse=True)
            else:
                _add_thresholded(view[k0:k0 + mine.shape[0]], mine,
                                 ctx.threshold)


class _Rebuild(NamedTuple):
    """What every face of a sharded rebuild reads."""

    group: object
    n: int
    rank: int
    held: HeldSlab
    ld: tuple  # the whole light grid
    lz: tuple  # this rank's light planes [z0, z1)
    tf_table: torch.Tensor
    win: object
    cc: object
    cd: object
    threshold: bool

    def window(self, z0: int, z1: int) -> L.ZWindow:
        return L.ZWindow(self.held.dims, self.held.held_z0, z0, z1)


@torch.no_grad()
def compute_illumination_sharded_v2(mesh, params: RenderParams,
                                    light_plans: Sequence[LightPlan],
                                    clip_center, clip_direction, light_dims,
                                    windowing_vec4=None,
                                    axis: str = "slab",
                                    apply_write_threshold: bool = False,
                                    held: HeldSlab | None = None,
                                    out: torch.Tensor | None = None,
                                    per_light: bool = False) -> torch.Tensor:
    """Slab-local illumination: this rank's Z chunk (LX, LY, LZ / n) of the
    light volume from its Z slab of the volume, ``params.volume`` (X, Y,
    Z / n); the chunks in rank order are the single-device rebuild's
    light volume, each face's light bit for bit. No tensor of the whole
    volume's size exists on any rank.

    - The occluder field of a face is one launch of K3's occluder source
      on the rank's slab and its halo (``held``, :func:`hold_slab`; held
      here for the call when not given), for its light planes and, on an
      X or Y face, the light halo's.
    - A Z face is scanned by K4 on the rank's chunk, with the light
      entering it as the carry from the upstream rank in the face's
      propagation order: a ring (span ``tbr.light_ring``).
    - An X or Y face: :func:`_xy_face` (K4 in chunks of
      :data:`LIGHT_HALO_SLICES` slices, the light halo exchanged between
      them, span ``tbr.light_halo``).

    Every face's light adds into the chunk in turn, as
    `models.pipeline.compute_illumination` sums them, or with
    ``per_light`` each light's faces into its contribution first and the
    contributions into the chunk, as `Renderer.reset_all_lights` does
    (the same for one light), each face's light gated by the write
    threshold when ``apply_write_threshold``. Volume
    and light dims must have integer ratios. ``windowing_vec4``: the
    window (center, width, low cutoff, high cutoff; host numbers go to K3
    by value), by default ``params``'s center and width with both cutoffs
    on. ``out``: the chunk to write (overwritten), else a new one."""
    group, n, rank = _axis(mesh, axis)
    ld = tuple(int(d) for d in light_dims)
    if ld[2] % n:
        raise ValueError(f"light Z {ld[2]} must divide the slab axis ({n})")
    slab = params.volume
    vz = slab.shape[2]
    vd = (int(slab.shape[0]), int(slab.shape[1]), vz * n)
    if any(v % l for v, l in zip(vd, ld)):
        raise ValueError("the sharded rebuild needs integer volume/light "
                         "resolution ratios")
    need = held_depth(light_plans, vd, ld, n)
    if held is None or held.depth < need:
        held = hold_slab(mesh, slab, vd, need, axis)
    lz = z_ranges(ld[2], n)[rank]
    if windowing_vec4 is None:
        windowing_vec4 = _windowing_vec4(params, True, True)
    ctx = _Rebuild(group, n, rank, held, ld, lz, params.tf_table,
                   windowing_vec4, clip_center, clip_direction,
                   apply_write_threshold)
    shape = (ld[0], ld[1], lz[1] - lz[0])
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=slab.device)
    else:
        out.zero_()
    contrib = None
    for li, plan in enumerate(light_plans):
        if li > 0 and per_light and contrib is None:
            contrib = torch.empty_like(out)
        target = contrib.zero_() if contrib is not None else out
        for fp in plan.face_plans:
            alpha = float(np.float32(float(params.light_intensities[li]))
                          * np.float32(fp.light_alpha))
            if L.face_axis(fp.face) == 2:
                _z_face(ctx, fp, alpha, target)
            else:
                _xy_face(ctx, fp, alpha, target)
        if contrib is not None:
            out += contrib
    return out
