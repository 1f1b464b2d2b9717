"""The functional lit pipeline: illumination rebuild plus frame in one
differentiable function.

Counterpart of `tbraymarcherplugin_tpu/models/pipeline.py`. The
interactive `Renderer` keeps state and updates lights incrementally; this
is one function from parameters to pixels, with the light-propagation
geometry (face choices and offsets, which depend on concrete light
directions) planned on the host. Differentiable leaves
(:class:`RenderParams`): the volume, the TF table, the window center and
width, and the per-light intensities. Call ``loss.backward()`` on a loss of
:func:`render_lit_scene`'s image, and every kernel of the path runs its
backward: the illumination's K7 (`ops/light_scan.py`) and K8
(`ops/tf_alpha.py`), and the frame's: K5 (`ops/shearwarp_grad.py`) and K6
(`ops/warp.py`) on the fused shear-warp path, K10b (`ops/tf_rgba.py`) on
the dense one with the ``"pallas"`` TF unit.

The frame is a shear-warp frame (the dense composite of
`ops.shearwarp.shearwarp_intermediate` with ``shearwarp_tf_unit`` "xla" or
"pallas", the fused ``"fused"`` path, or the forward-only
``shearwarp_stop_early`` path) or a ray march: ``"scan"``, ``"blocked"``
and ``"tiled2d"`` differentiate through autograd (`ops/march.py`),
``"pallas"`` is forward-only through K9 (`ops/fused_march.py`). The
defaults are the JAX package's. The sharded gradient all-reduce raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops import fused_march as FM
from ..ops import lighting as L
from ..ops import march as M
from ..ops import shearwarp as SW
from ..ops.composite import shearwarp_intermediate_fused
from ..ops.compositing import EARLY_TERMINATION_ALPHA
from ..ops.shearwarp_grad import shearwarp_intermediate_fused_diff
from ..ops.warp import warp_to_screen_fused


@dataclasses.dataclass(frozen=True)
class LightPlan:
    """Host-planned propagation geometry of one directional light: up to
    two :class:`~tbraymarcherplugin_tpu_torch.ops.lighting.
    FacePropagationPlan`, whose ``light_alpha`` holds the face weight only;
    the intensity multiplies in at run time, so the image's gradient to it
    is exact."""

    face_plans: tuple

    @staticmethod
    def create(local_dir, light_dims) -> "LightPlan":
        local_dir = np.asarray(local_dir, np.float64)
        local_dir = local_dir / np.linalg.norm(local_dir)
        axes = L.local_light_major_axes(local_dir)
        light_pos = -local_dir
        plans = tuple(
            L.plan_face_propagation(face, light_pos, tuple(light_dims), weight)
            for face, weight in zip(axes.faces, axes.weights)
            if weight > 0.0
        )
        return LightPlan(face_plans=plans)


@dataclasses.dataclass
class RenderParams:
    """The differentiable parameters, tensors on one device."""

    volume: torch.Tensor  # (X, Y, Z)
    tf_table: torch.Tensor  # (256, 4)
    window_center: torch.Tensor  # ()
    window_width: torch.Tensor  # ()
    light_intensities: torch.Tensor  # (n_lights,)


def _windowing_vec4(params: RenderParams, low_cutoff, high_cutoff):
    dev = params.volume.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())

    return torch.stack([
        f32(params.window_center), f32(params.window_width),
        f32(1.0 if low_cutoff else 0.0), f32(1.0 if high_cutoff else 0.0),
    ])


def compute_illumination(params: RenderParams,
                         light_plans: Sequence[LightPlan], clip_center,
                         clip_direction, light_dims, low_cutoff=True,
                         high_cutoff=True):
    """The illumination volume of all planned lights, differentiable to
    every leaf of ``params``: per face, the occluder field (K3, backward
    K8) and the propagation scan (K4, backward K7) of ``intensity *
    face weight``, without the write threshold (as the JAX package's
    differentiable callers build it: ``scan_impl="pallas"``,
    ``tf_impl="pallas_vjp"``)."""
    light_dims = tuple(int(d) for d in light_dims)
    win = _windowing_vec4(params, low_cutoff, high_cutoff)
    lv = torch.zeros(light_dims, dtype=torch.float32,
                     device=params.volume.device)
    for li, plan in enumerate(light_plans):
        intensity = params.light_intensities[li]
        for fp in plan.face_plans:
            lv = lv + L._propagate_one_face(
                params.volume, params.tf_table, win, clip_center,
                clip_direction, fp.uv_offset, fp.uvw_offset, fp.step_size,
                intensity * fp.light_alpha,  # light_alpha holds the weight
                fp.face, light_dims, apply_write_threshold=False,
            )
    return lv


MARCH_IMPLS = ("shearwarp", "scan", "blocked", "tiled2d", "pallas")


def render_lit_scene(params: RenderParams, rays, clip_center, clip_direction,
                     light_plans: tuple, light_dims: tuple, *,
                     step_count: int = 150, low_cutoff: bool = True,
                     high_cutoff: bool = True, checkpoint_every: int = 32,
                     early_termination: float = EARLY_TERMINATION_ALPHA,
                     march_impl: str = "blocked", shearwarp_plan=None,
                     shearwarp_dtype=torch.float32,
                     shearwarp_stop_early: bool = False,
                     shearwarp_tf_unit: str = "xla",
                     grad_allreduce_axis: str | None = None) -> torch.Tensor:
    """Lit render -> (height, width, 4): the illumination rebuild, then the
    frame by ``march_impl``. The defaults are the JAX package's: the
    blocked march, and for shear-warp the dense composite with the "xla"
    TF unit on float32 planes.

    - ``"shearwarp"``: the shear-warp composite and the screen warp;
      ``rays`` gives only the screen size (``rays.thickness.shape ==
      (height, width)``), the plan (`ops.shearwarp.plan_shearwarp`) encodes
      the camera. ``shearwarp_stop_early=True`` is the forward-only fast
      path (K1 + K2, run without autograd). Otherwise
      ``shearwarp_tf_unit`` picks the differentiable composite:
      ``"xla"`` and ``"pallas"`` the dense composite
      (`ops.shearwarp.shearwarp_intermediate`, checkpointed per block of 8
      planes; ``"pallas"`` windows through K10a/K10b) and the plain screen
      warp, ``"fused"`` the fused composite and warp (forward K1-K4,
      backward K5-K8). ``shearwarp_dtype`` rounds the pre-shear's operands
      (the bench's fused path stores bfloat16 planes; None: bfloat16 on
      the card and float32 on the CPU, on every branch); the dense
      composite's samples stay float32.
    - ``"scan"`` (`march.march_lit`, checkpointed every
      ``checkpoint_every`` steps), ``"blocked"`` (`march.march_lit_blocked`
      in blocks of ``checkpoint_every`` steps, `march_lit_tiled` above
      `march.DEFAULT_TILE_SIZE` rays) and ``"tiled2d"`` (32x32-pixel tiles)
      march ``rays`` with ``step_count`` steps per unit and differentiate
      through autograd; the illumination's backward runs K7 and K8.
    - ``"pallas"``: the march through K9, forward only: run it under
      ``torch.no_grad()`` (it raises when a leaf would record a gradient).
    """
    if march_impl not in MARCH_IMPLS:
        raise ValueError(f"unknown march_impl {march_impl!r}; choose "
                         f"{MARCH_IMPLS}")
    if grad_allreduce_axis is not None:
        raise NotImplementedError(
            "not ported yet: grad_allreduce_axis (the sharded gradient "
            "all-reduce). It comes with a later slice of the port "
            "(ROADMAP.md, 'Modules to port').")
    if march_impl != "shearwarp":
        win = _windowing_vec4(params, low_cutoff, high_cutoff)
        lv = compute_illumination(params, light_plans, clip_center,
                                  clip_direction, light_dims, low_cutoff,
                                  high_cutoff)
        args = (params.volume, params.tf_table, lv, rays, win, clip_center,
                clip_direction)
        kw = dict(step_count=step_count, early_termination=early_termination)
        if march_impl == "pallas":
            return FM.march_lit_fused(*args, **kw)
        if march_impl == "scan":
            return M.march_lit(*args, checkpoint_every=checkpoint_every, **kw)
        kw["block_size"] = checkpoint_every
        if march_impl == "tiled2d":
            return M.march_lit_tiled(
                *args, tile2d=(32, 32) if rays.thickness.dim() == 2 else None,
                **kw)
        if rays.thickness.numel() > M.DEFAULT_TILE_SIZE:
            return M.march_lit_tiled(*args, **kw)
        return M.march_lit_blocked(*args, **kw)
    if shearwarp_tf_unit not in ("fused", "xla", "pallas"):
        raise ValueError(f"unknown shearwarp_tf_unit {shearwarp_tf_unit!r}; "
                         f"choose 'fused', 'xla' or 'pallas'")
    if shearwarp_plan is None:
        raise ValueError("march_impl='shearwarp' needs shearwarp_plan "
                         "(ops.shearwarp.plan_shearwarp)")
    h, w = rays.thickness.shape
    if not shearwarp_stop_early and shearwarp_tf_unit != "fused":
        win = _windowing_vec4(params, low_cutoff, high_cutoff)
        lv = compute_illumination(params, light_plans, clip_center,
                                  clip_direction, light_dims, low_cutoff,
                                  high_cutoff)
        inter = SW.shearwarp_intermediate(
            params.volume, params.tf_table, lv, shearwarp_plan, win,
            clip_center, clip_direction, early_termination=early_termination,
            compute_dtype=shearwarp_dtype, tf_unit=shearwarp_tf_unit)
        return SW.warp_to_screen(inter, shearwarp_plan, w, h)
    composite = (shearwarp_intermediate_fused if shearwarp_stop_early
                 else shearwarp_intermediate_fused_diff)
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and not shearwarp_stop_early):
        win = _windowing_vec4(params, low_cutoff, high_cutoff)
        lv = compute_illumination(params, light_plans, clip_center,
                                  clip_direction, light_dims, low_cutoff,
                                  high_cutoff)
        inter = composite(params.volume, params.tf_table, lv, shearwarp_plan,
                          win, clip_center, clip_direction, early_termination,
                          shearwarp_dtype)
        return warp_to_screen_fused(inter, shearwarp_plan, w, h)
