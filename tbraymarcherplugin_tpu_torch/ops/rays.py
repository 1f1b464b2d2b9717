"""Ray generation, ray/box setup and the per-pixel jitter hash
(`PerformRaymarchCubeSetup`, `RaymarchMaterialCommon.usf:23-78`;
`RayAABBIntersection`, `RaymarcherCommon.usf:66-95`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene import Camera, VolumeTransform
from ..utils.device import to_device

_MASK32 = 0xFFFFFFFF


class RayBatch(NamedTuple):
    """Rays in the volume's UVW space: (..., 3) entry and unit direction,
    (...,) entry-to-exit thickness (>= 0)."""

    entry: torch.Tensor
    direction: torch.Tensor
    thickness: torch.Tensor


def ray_aabb_intersection(origin, direction, box_min=0.0, box_max=1.0):
    """Slab-method entry/exit times (t0, t1); a miss has t1 <= max(t0, 0)."""
    inv_dir = 1.0 / direction
    t_min = (box_min - origin) * inv_dir
    t_max = (box_max - origin) * inv_dir
    t0 = torch.minimum(t_min, t_max).amax(-1)
    t1 = torch.maximum(t_min, t_max).amin(-1)
    return t0, t1


def camera_rays(camera: Camera, width: int, height: int, device=None):
    """World-space (H, W, 3) origins and unit directions through every pixel
    center; pixel (0, 0) is top-left."""
    f32 = torch.float32
    aspect = height / width
    t = float(camera.tan_half_fov)
    xs = (torch.arange(width, dtype=f32, device=device) + 0.5) / width
    xs = xs * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=f32, device=device) + 0.5) / height * 2.0
    px, py = torch.meshgrid(xs * t, ys * t * aspect, indexing="xy")
    rot = to_device(camera.rotation, device)
    dirs = px[..., None] * rot[0] + py[..., None] * rot[1] + rot[2]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origins = to_device(camera.position, device).expand(dirs.shape)
    return origins, dirs


def _local_rays(camera: Camera, transform: VolumeTransform, width: int,
                height: int, device=None):
    """(H, W, 3) ray origins in UVW space and unit directions in local
    space (normalized after the inverse scale)."""
    origins_w, dirs_w = camera_rays(camera, width, height, device)
    rot = to_device(transform.rotation, device)
    trans = to_device(transform.translation, device)
    scale = to_device(transform.scale, device)
    origin_uvw = ((origins_w - trans) @ rot.T) / scale + 0.5
    dirs_local = (dirs_w @ rot.T) / scale
    dirs_local = dirs_local / torch.linalg.vector_norm(
        dirs_local, dim=-1, keepdim=True
    )
    return origin_uvw, dirs_local


def setup_rays(camera: Camera, transform: VolumeTransform, width: int,
               height: int, scene_depth=None, device=None) -> RayBatch:
    """World rays -> local UVW entry, direction (normalized in local space)
    and thickness, entry clamped in front of the camera and exit to
    ``scene_depth``: an optional (H, W) distance along each local ray where
    opaque scene geometry starts (`CalcSceneDepth`,
    `RaymarchMaterialCommon.usf:26-44`; :func:`scene_depth_from_plane` makes
    one)."""
    origin_uvw, dirs_local = _local_rays(camera, transform, width, height,
                                         device)
    t0, t1 = ray_aabb_intersection(origin_uvw, dirs_local)
    t0 = t0.clamp(min=0.0)
    if scene_depth is not None:
        t1 = torch.minimum(t1, to_device(scene_depth, t1.device,
                                         torch.float32))
    thickness = (t1 - t0).clamp(min=0.0)
    entry = origin_uvw + t0[..., None] * dirs_local
    return RayBatch(entry=entry, direction=dirs_local, thickness=thickness)


def scene_depth_from_plane(camera: Camera, transform: VolumeTransform,
                           width: int, height: int, plane_point, plane_normal,
                           device=None) -> torch.Tensor:
    """(H, W) depth of an opaque world-space plane along each local ray, in
    the units :func:`setup_rays`'s ``scene_depth`` takes; +inf where the
    plane is behind the camera or parallel to the ray."""
    origin_l, dirs_l = _local_rays(camera, transform, width, height, device)
    # x_w = (x_l * s) @ R + t, so the local normal is (n_w @ R^T) * s
    n_l = torch.as_tensor(
        (np.asarray(plane_normal, np.float32) @ transform.rotation.T)
        * transform.scale, device=device)
    p_l = torch.as_tensor(transform.world_to_uvw(plane_point), device=device)
    denom = (dirs_l * n_l).sum(-1)
    tnum = ((p_l - origin_l) * n_l).sum(-1)
    flat = denom.abs() < 1e-12
    t = tnum / torch.where(flat, torch.full_like(denom, 1e-12), denom)
    return torch.where(flat | (t <= 0.0), torch.full_like(t, float("inf")), t)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for int64 ``v`` in [0, 2^32) without overflowing
    int64: split ``c`` into 16-bit halves."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def pcg_hash_3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """PCG-style 3D hash -> uint32 values held in int64, bit-exact with the
    JAX package's uint32 arithmetic (a stand-in for UE's `Rand3DPCG16`)."""
    v = (_mul32(x.long(), 1664525) + _mul32(y.long(), 1013904223)
         + _mul32(z.long(), 69069)) & _MASK32
    v = v ^ (v >> 16)
    v = _mul32(v, 2654435769)
    v = v ^ (v >> 13)
    v = _mul32(v, 2654435769)
    return v ^ (v >> 16)


def jitter_values(width: int, height: int, frame_index: int = 0,
                  device=None) -> torch.Tensor:
    """(height, width) per-pixel temporal jitter in [0, 1)
    (`RaymarchMaterialCommon.usf:73-78`)."""
    xx = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    yy = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    f = torch.full((height, width), frame_index % 8, dtype=torch.int64,
                   device=device)
    h = pcg_hash_3d(xx.expand(height, width), yy.expand(height, width), f)
    return (h & 0xFFFF).to(torch.float32) / 65535.0
