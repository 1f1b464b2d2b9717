"""Scene orchestration: the `ARaymarchVolume` equivalent.

Counterpart of `tbraymarcherplugin_tpu/renderer.py`. :class:`Renderer` owns
the volume, TF, windowing and illumination state, tracks what changed since
the last frame and updates the illumination volume accordingly
(`RaymarchVolume.cpp:327-416`):

- volume transform, clip plane, windowing or TF changed -> full rebuild
- a single light moved                                   -> selective update
- more than half the lights changed                      -> full rebuild

A frame in any of the three render modes (lit, intensity, octree) is a
shear-warp render: the host plan (cached per camera), the composite
(kernel K1 in the mode's variant, with a scene-depth ceiling when the
caller gives a depth map) and the two-pass screen warp (kernel K2). When
the camera sits inside the volume's dominant slab the factorization does
not exist, and the frame is a ray march instead: in lit mode kernel K9 by
default, or the blocked march with empty-space skipping, or the
step-by-step march (``march_impl``); in the other modes
`march.march_intensity` or `octree.march_octree`.

With ``mesh=`` and ``global_dims=`` a `Renderer` holds one Z slab of a
volume that only several cards hold together (one process a card, the
mesh's ``"slab"`` axis): its slab of the volume, the halo planes its
rebuild reads, and its Z chunk of the light volume. Its setters are the
single-card ones, called on every rank; the rebuild is
`parallel.slab_sharding.compute_illumination_sharded_v2` and the lit
frame `parallel.shearwarp_sharding.shearwarp_lit_slab_sharded`, both
collectives, the frame whole on rank 0. March frames, the intensity and
octree modes, an incremental light move, a half-resolution light volume
and the fit (`models/`) are not sharded: they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .ops import fused_march as FM
from .ops import lighting as L
from .ops import march as M
from .ops import octree as O
from .ops import preshear as PS
from .ops import shearwarp as SW
from .ops.composite import shearwarp_intermediate_fused
from .ops.rays import jitter_values, setup_rays
from .ops.transfer import default_grayscale_tf
from .ops.warp import warp_to_screen_fused
from .scene import Camera, ClipPlane, DirLight, VolumeTransform
from .utils import profiling as P
from .utils.device import resolve_device
from .utils.volume_info import VolumeInfo, WindowingParameters

RENDER_MODES = ("lit", "intensity", "octree")
MARCH_IMPLS = ("auto", "shearwarp", "pallas", "blocked", "scan")
# The occupancy grid's cells are 2^OCCUPANCY_MIP voxels wide: the finest
# that `octree.occupancy_grid` takes. Finer cells hold more of K9's empty
# steps; the blocked march takes the same time at mip 1 and 3 (PERF.md).
OCCUPANCY_MIP = 1


@dataclasses.dataclass
class RendererConfig:
    """Quality and behaviour knobs (see the JAX package's RendererConfig).

    - ``step_count``: sample planes per frame (`RaymarchingSteps`).
    - ``render_mode``: "lit", "intensity" (first-hit windowed intensity)
      or "octree" (unlit, nearest texels of mip ``octree_mip``).
    - ``light_volume_half_resolution``: 8x fewer light voxels.
    - ``light_volume_32bit``: False emulates the reference's 8-bit light
      volume by quantizing after every update.
    - ``jitter``: per-pixel temporal jitter (default on): of the plane
      phase on shear-warp frames, of the ray start on march frames.
    - ``compat_final_step``: the march's final fractional step keeps the
      reference's opacity step (see `ops/march.py`).
    - ``march_impl``: "auto" and "shearwarp" render by shear-warp and fall
      back to the march for a camera inside the dominant slab (lit: K9);
      "pallas" always marches, in lit mode through K9
      (`ops/fused_march.py`), "blocked" through
      `march.march_lit_tiled`/`march_lit_blocked`, "scan" through
      `march.march_lit`; the intensity and octree modes march through
      `march.march_intensity` and `octree.march_octree` for every value.
    - ``empty_space_skipping``: the march skips what the occupancy grid
      (`ops/octree.py`) proves empty: K9 its samples, the "blocked" march
      its blocks; exact for the image. The grid is built on the second
      frame after the volume, window or TF changes, so that a drag, which
      changes them every frame, does not rebuild it every frame.
    """

    step_count: int = 150
    render_mode: str = "lit"
    light_volume_half_resolution: bool = False
    light_volume_32bit: bool = True
    octree_mip: int = 0
    jitter: bool = True
    early_termination: float = 0.95
    apply_write_threshold: bool = True
    compat_final_step: bool = True
    march_impl: str = "auto"
    empty_space_skipping: bool = True


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Emulate 8-bit texture storage: round to 1/255 steps in [0, 1]."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


class Renderer(nn.Module):
    """Holds scene state on ``device``, keeps the illumination volume fresh
    and renders frames. With no ``device``, a tensor volume keeps its
    device and anything else goes to the card (`utils.device.
    resolve_device`); the CPU only when asked for."""

    def __init__(self, volume, info: Optional[VolumeInfo] = None,
                 tf_table=None, windowing: Optional[WindowingParameters] = None,
                 transform: Optional[VolumeTransform] = None,
                 clip_plane: Optional[ClipPlane] = None,
                 config: Optional[RendererConfig] = None, device=None,
                 mesh=None, global_dims=None):
        super().__init__()
        self.config = config or RendererConfig()
        if self.config.march_impl not in MARCH_IMPLS:
            raise ValueError(f"unknown march_impl {self.config.march_impl!r}; "
                             f"choose {MARCH_IMPLS}")
        self._check_mode(self.config.render_mode)
        if (mesh is None) != (global_dims is None):
            raise ValueError("a slab-sharded Renderer takes both mesh= and "
                             "global_dims=")
        self._mesh = mesh
        self._held = None
        volume = torch.as_tensor(volume, dtype=torch.float32,
                                 device=resolve_device(device, like=volume))
        if mesh is not None:
            # imported here: `parallel/` (the device mesh, DTensor) adds
            # over a second to every import of the renderer
            from .parallel import slab_sharding as SS

            self._check_sharded()
            self._dims = tuple(int(d) for d in global_dims)
            self._held = SS.hold_slab(mesh, volume, self._dims,
                                      SS._halo_depth(self._dims, self._dims))
            volume = self._held.slab
        else:
            self._dims = tuple(volume.shape)
        self._has_real_info = info is not None
        self.info = info or VolumeInfo(
            dimensions=self._dims, is_normalized=True,
            min_value=0.0, max_value=1.0,
        )
        self.register_buffer("volume", volume)
        self.register_buffer(
            "tf_table",
            default_grayscale_tf(device=volume.device) if tf_table is None
            else torch.as_tensor(tf_table, dtype=torch.float32,
                                 device=volume.device),
        )
        self.windowing = windowing or (
            self.info.default_windowing if info else WindowingParameters()
        )
        self.transform = transform or VolumeTransform.create(
            scale=self._default_scale()
        )
        self.clip_plane = clip_plane or ClipPlane.disabled()
        self.lights: Dict[str, DirLight] = {}
        self._prev_lights: Dict[str, tuple] = {}
        self.register_buffer("light_volume", L.clear_light_volume(
            self.light_volume_dims(), device=volume.device))
        self._frame_index = 0
        self._renders = 0
        self._lights_dirty = True
        self._sw_key = None
        self._sw_plan = None
        # the frame volume's per-slice ranges (`_slice_range`)
        self._ranges_of, self._ranges = None, {}
        # the occupancy grid of empty-space skipping, built from the octree
        # on the second frame with the same volume, TF and window
        # (`_occ_due`) and dropped when they change
        self.octree: Optional[O.Octree] = None
        self._octree_dirty = True
        self._occ: Optional[O.OccupancyGrid] = None
        self._occ_due = False

    @property
    def device(self) -> torch.device:
        return self.volume.device

    @property
    def sharded(self) -> bool:
        """Whether this Renderer holds one Z slab (``mesh=``)."""
        return self._mesh is not None

    def _check_sharded(self):
        """Refuse what a slab-sharded Renderer does not do."""
        if self.config.render_mode != "lit":
            raise NotImplementedError(
                f"a slab-sharded Renderer renders lit frames only, not "
                f"{self.config.render_mode!r}: the intensity and octree "
                f"modes have no sharded composite")
        if self.config.light_volume_half_resolution:
            raise NotImplementedError(
                "a slab-sharded Renderer keeps a full-resolution light "
                "volume: its frame pre-shears the light chunk in the "
                "volume's slab")
        if self.config.march_impl not in ("auto", "shearwarp"):
            raise NotImplementedError(
                "a slab-sharded Renderer renders shear-warp frames only: "
                "the march has no sharded path through the Renderer")

    @staticmethod
    def _check_mode(mode):
        if mode not in RENDER_MODES:
            raise ValueError(f"unknown render mode {mode!r}; choose {RENDER_MODES}")

    def _default_scale(self):
        """World size of the proxy cube: WorldDimensions / 10 with real
        metadata (mm -> cm), the unit cube for a bare array."""
        if not self._has_real_info:
            return (1.0, 1.0, 1.0)
        wd = self.info.world_dimensions
        if all(d > 0 for d in wd):
            return tuple(d / 10.0 for d in wd)
        return (1.0, 1.0, 1.0)

    def light_volume_dims(self):
        """The light volume's dims: on a sharded Renderer its chunk's."""
        dims = tuple(self.volume.shape)
        if self.config.light_volume_half_resolution:
            return tuple(max(1, d // 2) for d in dims)
        return dims

    # --- change notification -------------------------------------------------

    def set_volume(self, volume, info: Optional[VolumeInfo] = None):
        volume = torch.as_tensor(volume, dtype=torch.float32,
                                 device=self.device)
        if self.sharded:  # the rank's new slab, its halo exchanged again
            from .parallel import slab_sharding as SS

            self.volume, depth, self._held = volume[:0], self._held.depth, None
            self._held = SS.hold_slab(self._mesh, volume, self._dims, depth)
            volume = self._held.slab
        self.volume = volume
        if info is not None:
            self.info = info
            self.windowing = info.default_windowing
            self.transform = VolumeTransform.create(scale=self._default_scale())
        self.light_volume = L.clear_light_volume(self.light_volume_dims(),
                                                 device=self.device)
        self._lights_dirty = True
        self._octree_dirty = True
        self._drop_occupancy()
        self._ranges_of, self._ranges = None, {}

    def set_tf(self, tf_table):
        self.tf_table = torch.as_tensor(tf_table, dtype=torch.float32,
                                        device=self.device)
        self._lights_dirty = True
        self._drop_occupancy()

    def set_window_center(self, center):
        self.windowing = dataclasses.replace(self.windowing, center=center)
        self._lights_dirty = True
        self._drop_occupancy()

    def set_window_width(self, width):
        self.windowing = dataclasses.replace(self.windowing, width=width)
        self._lights_dirty = True
        self._drop_occupancy()

    def set_low_cutoff(self, enabled: bool):
        self.windowing = dataclasses.replace(self.windowing, low_cutoff=enabled)
        self._lights_dirty = True
        self._drop_occupancy()

    def set_high_cutoff(self, enabled: bool):
        self.windowing = dataclasses.replace(self.windowing,
                                             high_cutoff=enabled)
        self._lights_dirty = True
        self._drop_occupancy()

    def set_transform(self, transform: VolumeTransform):
        self.transform = transform
        self._lights_dirty = True

    def set_clip_plane(self, clip_plane: ClipPlane):
        self.clip_plane = clip_plane
        self._lights_dirty = True

    def set_render_mode(self, mode: str):
        self._check_mode(mode)
        if self.sharded and mode != "lit":
            raise NotImplementedError(
                f"a slab-sharded Renderer renders lit frames only, not "
                f"{mode!r}")
        self.config.render_mode = mode

    def set_raymarch_steps(self, step_count: int):
        self.config.step_count = int(step_count)

    def add_light(self, name: str, light: DirLight):
        self.lights[name] = light

    def update_light(self, name: str, light: DirLight):
        """Move or re-dim one light: the selective-update path."""
        self.lights[name] = light

    def remove_light(self, name: str):
        """Remove a light, subtracting its contribution incrementally."""
        light = self.lights.pop(name)
        prev = self._prev_lights.pop(name, None)
        if self.sharded:  # the next frame rebuilds the chunk whole
            self._lights_dirty = True
            return
        if prev is not None and not self._lights_dirty:
            self.light_volume = L.add_dir_light(
                self.light_volume, *self._light_args(),
                self._local_dir(light), light.intensity, added=False,
                apply_write_threshold=self.config.apply_write_threshold,
            )
            self._maybe_quantize()

    # --- illumination maintenance (the Tick logic) ---------------------------

    def _light_args(self):
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        return (self.volume, self.tf_table, self.windowing.as_vec4(),
                local_clip.center, local_clip.direction)

    def _local_dir(self, light: DirLight) -> np.ndarray:
        return self.transform.local_light_direction(light)

    def _light_key(self, light: DirLight):
        return (
            tuple(np.asarray(light.direction).tolist()),
            float(light.intensity),
            tuple(np.asarray(self.transform.rotation).ravel().tolist()),
        )

    def _maybe_quantize(self):
        if not self.config.light_volume_32bit:
            self.light_volume = _quantize_u8(self.light_volume)

    def reset_all_lights(self):
        """Full illumination rebuild (`ResetAllLights`, cpp:418-451)."""
        if self.sharded:
            self._reset_all_lights_sharded()
            return
        args = self._light_args()
        lv = L.clear_light_volume(self.light_volume_dims(), device=self.device)
        for light in self.lights.values():
            lv = L.add_dir_light(
                lv, *args, self._local_dir(light), light.intensity,
                apply_write_threshold=self.config.apply_write_threshold,
            )
        self.light_volume = lv
        self._maybe_quantize()
        self._prev_lights = {n: self._light_key(li)
                             for n, li in self.lights.items()}
        self._lights_dirty = False

    def _reset_all_lights_sharded(self):
        """The rebuild of this rank's light chunk, a collective: every
        light's local plan (the whole volume's geometry), the halo held
        deeper first where an X or Y face's chunks need it."""
        from .models.pipeline import LightPlan, RenderParams
        from .parallel import slab_sharding as SS

        plans = [LightPlan.create(self._local_dir(li), self._dims)
                 for li in self.lights.values()]
        world = self._dims[2] // (self._held.z1 - self._held.z0)
        need = SS.held_depth(plans, self._dims, self._dims, world)
        if self._held.depth < need:  # once: the old halo freed first
            slab = self._held.slab.clone()
            self.volume, self._held = slab.new_empty(0), None
            self._held = SS.hold_slab(self._mesh, slab, self._dims, need)
            del slab
            self.volume = self._held.slab
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        params = RenderParams(
            volume=self.volume, tf_table=self.tf_table,
            window_center=None, window_width=None,
            light_intensities=torch.tensor(
                [float(li.intensity) for li in self.lights.values()],
                dtype=torch.float32))
        SS.compute_illumination_sharded_v2(
            self._mesh, params, plans, local_clip.center,
            local_clip.direction, self._dims,
            apply_write_threshold=self.config.apply_write_threshold,
            held=self._held, out=self.light_volume,
            windowing_vec4=self.windowing.as_vec4(), per_light=True)
        self._maybe_quantize()
        self._prev_lights = {n: self._light_key(li)
                             for n, li in self.lights.items()}
        self._lights_dirty = False

    def ensure_lighting(self):
        """Bring the illumination volume up to date."""
        if self.config.render_mode != "lit":
            return
        if self._lights_dirty or set(self._prev_lights) != set(self.lights):
            with P.span(P.LIGHTING):
                self.reset_all_lights()
            return
        changed = [name for name, light in self.lights.items()
                   if self._light_key(light) != self._prev_lights[name]]
        if not changed:
            return
        rebuild = (len(changed) > max(1, len(self.lights) // 2)
                   and len(self.lights) > 1)
        if self.sharded and not rebuild:
            raise NotImplementedError(
                "a slab-sharded Renderer rebuilds the illumination whole: "
                "an incremental light move (change_dir_light) has no "
                "sharded path; change the window, TF or clip plane with it "
                "to rebuild")
        with P.span(P.LIGHTING):
            if rebuild:
                self.reset_all_lights()
                return
            args = self._light_args()
            for name in changed:
                light = self.lights[name]
                old_dir, old_intensity, _ = self._prev_lights[name]
                # The old key was captured under the current transform.
                old_local = self._local_dir(
                    DirLight.create(old_dir, old_intensity))
                self.light_volume = L.change_dir_light(
                    self.light_volume, *args, old_local, old_intensity,
                    self._local_dir(light), light.intensity,
                    apply_write_threshold=self.config.apply_write_threshold,
                )
                self._prev_lights[name] = self._light_key(light)
            self._maybe_quantize()

    def ensure_octree(self, force: bool = False):
        """Bring the min/max pyramid up to date (`bRequestedOctreeRebuild`)
        in octree mode, or in any mode with ``force``."""
        if not (force or self.config.render_mode == "octree"):
            return
        if self.sharded:
            raise NotImplementedError(
                "a slab-sharded Renderer builds no octree: the octree mode "
                "and empty-space skipping belong to march frames")
        if self.octree is None or self._octree_dirty:
            self.octree = O.build_octree(self.volume, max_value=1.0)
            self._octree_dirty = False

    # --- rendering -----------------------------------------------------------

    def render(self, camera: Camera, width: int, height: int,
               scene_depth=None) -> torch.Tensor:
        """Render one frame in the current render mode: (height, width, 4)
        RGBA on the renderer's device.

        ``scene_depth``: optional (height, width) occluder depth along each
        normalized local ray (`rays.scene_depth_from_plane` makes one), the
        reference's depth-buffer clamp (`RaymarchMaterialCommon.usf:26-44`):
        a per-pixel λ ceiling on shear-warp frames
        (`shearwarp.depth_to_lambda_max`), the rays' exit on march frames.
        """
        self._renders += 1
        with P.span(P.RENDER, self._renders):
            return self._render(camera, width, height, scene_depth)

    def _render(self, camera: Camera, width: int, height: int,
                scene_depth=None) -> torch.Tensor:
        mode = self.config.render_mode
        self._check_mode(mode)
        self.ensure_lighting()
        self.ensure_octree()
        if self.sharded:
            return self._render_sharded(camera, width, height, scene_depth)
        if self.config.march_impl in ("auto", "shearwarp"):
            img = self._render_shearwarp(camera, width, height, scene_depth)
            if img is not None:
                return img
        with P.span(P.RAYS):
            rays = setup_rays(camera, self.transform, width, height,
                              scene_depth=scene_depth, device=self.device)
            jitter = None
            if self.config.jitter:
                # the march's own per-pixel field; the frame index advances
                # only on frames that march
                jitter = jitter_values(width, height, self._frame_index,
                                       device=self.device)
                self._frame_index += 1
        if mode == "lit":
            return self._render_lit(rays, jitter)
        win = self.windowing.as_vec4(self.device)
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        if mode == "intensity":
            return M.march_intensity(
                self.volume, rays, win, local_clip.center,
                local_clip.direction, jitter=jitter,
                step_count=self.config.step_count)
        return O.march_octree(
            self.octree, self.tf_table, rays, win, local_clip.center,
            local_clip.direction, jitter=jitter,
            step_count=self.config.step_count, mip=self.config.octree_mip,
            early_termination=self.config.early_termination)

    def _plan(self, camera: Camera, width: int, height: int, vol_shape,
              light_shape):
        """The shear-warp plan of this frame (None inside the dominant
        slab), cached per camera, volume, mode and mip."""
        key = (
            self.config.render_mode, self.config.octree_mip,
            camera.position.tobytes(), camera.rotation.tobytes(),
            float(camera.tan_half_fov), self.transform.rotation.tobytes(),
            self.transform.translation.tobytes(),
            self.transform.scale.tobytes(), width, height,
            tuple(vol_shape), tuple(light_shape), self.config.step_count,
        )
        if self._sw_key != key:
            with P.span(P.PLAN):
                self._sw_plan = SW.plan_shearwarp(
                    camera, self.transform, vol_shape, light_shape, width,
                    height, max_planes=self.config.step_count)
            self._sw_key = key
        return self._sw_plan

    def _slice_range(self, vol, axis: int):
        """The frame volume's per-slice (min, max) across ``axis``
        (`preshear.slice_ranges`), which the chunk occupancy reads: kept
        while the Renderer holds the same volume (or, in octree mode, the
        same octree), so that its frames reduce it once."""
        held = self.octree if self.config.render_mode == "octree" \
            else self.volume
        if self._ranges_of is not held:
            self._ranges_of, self._ranges = held, {}
        key = (self.config.render_mode, self.config.octree_mip, axis)
        if key not in self._ranges:
            self._ranges[key] = PS.slice_ranges(vol, axis)
        return self._ranges[key]

    def _mode_volume(self) -> torch.Tensor:
        """The volume an intensity or octree frame composites: the volume;
        in octree mode mip ``octree_mip`` of the pow2-padded max pyramid
        (`render` keeps it up to date), its z cut to the data's extent."""
        if self.config.render_mode != "octree":
            return self.volume
        oc = self.octree
        mip = oc.mips[self.config.octree_mip]
        z_eff = max(1, -(-mip.shape[2] * oc.data_dims[2]
                         // oc.mips[0].shape[2]))
        return mip[:, :, :z_eff]

    def _render_shearwarp(self, camera: Camera, width: int, height: int,
                          scene_depth=None):
        """The shear-warp frame in the current render mode, or None when
        the camera sits inside the volume's dominant slab (no plan: the
        caller marches instead). Lit frames composite the volume and the
        light volume; intensity frames the first hit of the volume; octree
        frames the unlit, nearest-texel composite of the mode's mip."""
        mode = self.config.render_mode
        if mode == "lit":
            vol, light = self.volume, self.light_volume
            plan = self._plan(camera, width, height, vol.shape, light.shape)
        else:
            vol, light = self._mode_volume(), None
            plan = self._plan(camera, width, height, vol.shape, vol.shape)
        if plan is None:
            return None
        jitter = None
        if self.config.jitter:
            jitter = jitter_values(plan.n2, plan.n1, self._frame_index,
                                   device=self.device)
            self._frame_index += 1
        depth_lam = None
        if scene_depth is not None:
            depth_lam = SW.depth_to_lambda_max(plan, scene_depth, width,
                                               height, device=self.device)
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        inter = shearwarp_intermediate_fused(
            vol, self.tf_table, light, plan, self.windowing.as_vec4(),
            local_clip.center, local_clip.direction,
            early_termination=self.config.early_termination, jitter=jitter,
            depth_lam=depth_lam,
            mode={"lit": "lit", "intensity": "intensity",
                  "octree": "unlit"}[mode],
            sample_nearest=mode == "octree",
            slice_range=None if mode == "intensity"
            else self._slice_range(vol, plan.axis),
        )
        return warp_to_screen_fused(inter, plan, width, height)

    def _render_sharded(self, camera: Camera, width: int, height: int,
                        scene_depth=None):
        """The slab-sharded lit frame (a collective): the whole frame on
        rank 0, None on the others."""
        from .parallel import shearwarp_sharding as SSW

        plan = self._plan(camera, width, height, self._dims, self._dims)
        if plan is None:
            raise NotImplementedError(
                "the camera sits inside the volume's dominant slab: a march "
                "frame, which a slab-sharded Renderer does not render")
        jitter = None
        if self.config.jitter:
            jitter = jitter_values(plan.n2, plan.n1, self._frame_index,
                                   device=self.device)
            self._frame_index += 1
        depth_lam = None
        if scene_depth is not None:
            depth_lam = SW.depth_to_lambda_max(plan, scene_depth, width,
                                               height, device=self.device)
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        return SSW.shearwarp_lit_slab_sharded(
            self._mesh, self.volume, self.tf_table, self.light_volume, plan,
            self._dims, self._dims, self.windowing.as_vec4(),
            local_clip.center, local_clip.direction, width, height,
            early_termination=self.config.early_termination, jitter=jitter,
            depth_lam=depth_lam)

    def _drop_occupancy(self):
        self._occ = None
        self._occ_due = False

    def occupancy(self) -> O.OccupancyGrid:
        """The occupancy grid of empty-space skipping for the current
        volume, window and TF (with `octree.LERP_MARGIN`, so skipping is
        exact to the bit), built from the octree on first use."""
        if self.sharded:
            raise NotImplementedError(
                "a slab-sharded Renderer builds no occupancy grid: it "
                "renders no march frame")
        if self._occ is None:
            with P.span(P.OCCUPANCY):
                self.ensure_octree(force=True)
                self._occ = O.occupancy_grid(
                    self.octree, self.windowing.as_vec4(self.device),
                    self.tf_table, mip=OCCUPANCY_MIP)
        return self._occ

    def _render_lit(self, rays, jitter):
        """The lit ray march of ``rays`` by ``march_impl``."""
        cfg = self.config
        win = self.windowing.as_vec4(self.device)
        local_clip = self.transform.local_clip_plane(self.clip_plane)
        args = (self.volume, self.tf_table, self.light_volume, rays, win,
                local_clip.center, local_clip.direction)
        kw = dict(jitter=jitter, step_count=cfg.step_count,
                  early_termination=cfg.early_termination,
                  compat_final_step=cfg.compat_final_step)
        if cfg.march_impl == "scan":
            return M.march_lit(*args, **kw)
        occ = None
        if cfg.empty_space_skipping:
            # a window drag changes the grid every frame, and its rebuild
            # costs more than K9 saves by it in one frame (PERF.md)
            if self._occ is not None or self._occ_due:
                occ = self.occupancy()
            self._occ_due = True
        if cfg.march_impl != "blocked":
            # "auto", "shearwarp" and "pallas": K9, which has no window limit
            return FM.march_lit_fused(*args, **kw, occupancy=occ)
        ess = {}
        if occ is not None:
            ess = dict(occ_grid=occ.grid, occ_scale=occ.cell_scale,
                       skip_blocks=True)
        if rays.thickness.numel() > M.DEFAULT_TILE_SIZE or ess:
            return M.march_lit_tiled(
                *args, tile2d=(32, 32) if rays.thickness.dim() == 2 else None,
                **ess, **kw)
        return M.march_lit_blocked(*args, **kw)

    # --- windowing getters (`RaymarchVolume.h:202-266` of the reference) ------

    def get_min_max_values(self):
        """The volume's original (min, max) data values."""
        return self.info.min_value, self.info.max_value

    def get_window_center(self) -> float:
        """The center as the frames use it: a float32 value."""
        return float(torch.as_tensor(self.windowing.center,
                                     dtype=torch.float32))

    def get_window_width(self) -> float:
        """The width as the frames use it: a float32 value."""
        return float(torch.as_tensor(self.windowing.width,
                                     dtype=torch.float32))
