"""The reference's lit frame as a viewer's renderer makes it: the
illumination rebuild, then a shear-warp frame, or a ray march where the
camera sits inside the volume's dominant slab.

This follows the program's `Renderer` (`renderer.py`: `reset_all_lights`,
`_render_shearwarp`, `_render_lit`) with the reference's own plain
pieces, so that every number it gives is worked out again from the
inputs the benchmark made: the volume, the TF table, the window, the
lights, the clip plane and the camera. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import lighting, march, shearwarp
from .common import EARLY_TERMINATION_ALPHA, jitter_values
from .scene import ClipPlane, DirLight, VolumeTransform


@dataclasses.dataclass
class Scene:
    """What a frame depends on besides its camera. ``window`` holds
    (center, width, low cutoff, high cutoff); ``lights`` world
    (direction, intensity) pairs; ``clip`` a world-space clip plane."""

    volume: torch.Tensor
    table: torch.Tensor
    window: tuple
    transform: VolumeTransform
    lights: tuple
    clip: ClipPlane
    width: int
    height: int
    step_count: int = 150
    jitter: bool = True
    early_termination: float = EARLY_TERMINATION_ALPHA

    def window_tensor(self) -> torch.Tensor:
        return torch.tensor([float(np.float32(x)) for x in self.window],
                            dtype=torch.float32, device=self.volume.device)

    def local_clip(self) -> ClipPlane:
        return self.transform.local_clip_plane(self.clip)


def illumination(scene: Scene) -> torch.Tensor:
    """The light volume of every light (a full rebuild, full resolution,
    32-bit, the write threshold applied)."""
    clip = scene.local_clip()
    lights = [(scene.transform.local_light_direction(DirLight.create(d, i)),
               np.float32(i)) for d, i in scene.lights]
    return lighting.reset_all_lights(
        scene.volume, scene.table, scene.window_tensor(), clip.center,
        clip.direction, lights, tuple(scene.volume.shape))


def plan(scene: Scene, camera):
    """The shear-warp plan of ``camera``, None inside the dominant slab."""
    shape = tuple(scene.volume.shape)
    return shearwarp.plan_shearwarp(camera, scene.transform, shape, shape,
                                    scene.width, scene.height,
                                    max_planes=scene.step_count)


def frame(scene: Scene, camera, light_volume: torch.Tensor, frame_index: int,
          plane_dtype=torch.float32, stats: dict | None = None,
          storage_dtype=None) -> torch.Tensor:
    """The (height, width, 4) frame the renderer's ``frame_index``-th
    render gives (the jitter's phase follows the frame index).

    ``plane_dtype``: the storage type of the pre-sheared planes of a
    shear-warp frame. ``storage_dtype``, when given, rounds the volume and
    the light volume a march reads to that type (the march's control).
    ``stats`` receives the composite's or the march's counts of work."""
    clip = scene.local_clip()
    win = scene.window_tensor()
    p = plan(scene, camera)
    dev = scene.volume.device
    if p is not None:
        jitter = (jitter_values(p.n2, p.n1, frame_index, device=dev)
                  if scene.jitter else None)
        kw = shearwarp.prepare(scene.volume, scene.table, light_volume, p,
                               win, clip.center, clip.direction, jitter,
                               scene.early_termination, plane_dtype)
        inter = shearwarp.composite_plain(**kw, stats=stats)
        return shearwarp.intermediate_to_screen(inter, p, scene.width,
                                                scene.height)
    rays = march.setup_rays(camera, scene.transform, scene.width,
                            scene.height, device=dev)
    jitter = (jitter_values(scene.width, scene.height, frame_index,
                            device=dev) if scene.jitter else None)
    vol, light = scene.volume, light_volume
    if storage_dtype is not None:
        vol = vol.to(storage_dtype).to(torch.float32)
        light = light.to(storage_dtype).to(torch.float32)
    w = [float(x) for x in win.tolist()]
    return march.march_lit(vol, scene.table, light, rays, w, clip.center,
                           clip.direction, jitter, scene.step_count,
                           scene.early_termination, stats=stats)
