"""Differentiable fitting: gradient descent of the TF, the window, the
volume or the light intensities toward a target render (inverse
rendering).

Counterpart of `tbraymarcherplugin_tpu/models/fitting.py`. The optimizer
is `torch.optim.Adam` with ``optax.adam``'s defaults (betas (0.9, 0.999),
eps 1e-8). Every leaf takes a gradient, so the per-leaf gradient norms of
the metrics are the unmasked ones; the leaves a :class:`FitConfig` does not
train get a zero gradient before the step and stay where they are. After
each step the TF table is clamped to [0, 1] and the window width to at
least 1e-3.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .pipeline import RenderParams, render_lit_scene

FIELDS = ("volume", "tf_table", "window_center", "window_width",
          "light_intensities")


@dataclasses.dataclass
class FitConfig:
    """What to fit and how. The JAX package's ``illumination_scan`` and
    ``illumination_tf_impl`` are left out: the port's `render_lit_scene`
    has one illumination implementation (K3/K4 forward, K7/K8 backward)."""

    learning_rate: float = 3e-2
    steps: int = 200
    optimize_tf: bool = True
    optimize_window: bool = True
    optimize_volume: bool = False
    optimize_lights: bool = False
    step_count: int = 64  # march steps during fitting
    tf_smoothness_weight: float = 1e-3
    # Renderer of the differentiable forward: "blocked" (the exact
    # reference parameterization) or "shearwarp" (the dense shear-warp
    # composite; needs shearwarp_plan from ops.shearwarp.plan_shearwarp).
    march_impl: str = "blocked"
    shearwarp_plan: object = None


def image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L2 on RGBA."""
    return torch.mean((rendered - target) ** 2)


def tf_smoothness(tf_table: torch.Tensor) -> torch.Tensor:
    """Total-variation regularizer keeping fitted TF tables physical."""
    return torch.mean(torch.square(tf_table[1:] - tf_table[:-1]))


def make_loss_fn(rays, target: torch.Tensor, clip_center, clip_direction,
                 light_plans: tuple, light_dims: tuple,
                 config: FitConfig) -> Callable[[RenderParams], torch.Tensor]:
    def loss_fn(params: RenderParams) -> torch.Tensor:
        img = render_lit_scene(
            params, rays, clip_center, clip_direction, light_plans,
            light_dims, step_count=config.step_count,
            march_impl=config.march_impl,
            shearwarp_plan=config.shearwarp_plan)
        loss = image_loss(img, target)
        if config.tf_smoothness_weight:
            loss = loss + config.tf_smoothness_weight * tf_smoothness(
                params.tf_table)
        return loss

    return loss_fn


def _param_mask(config: FitConfig) -> RenderParams:
    """1/0 per leaf: which leaves train."""
    return RenderParams(
        volume=1.0 if config.optimize_volume else 0.0,
        tf_table=1.0 if config.optimize_tf else 0.0,
        window_center=1.0 if config.optimize_window else 0.0,
        window_width=1.0 if config.optimize_window else 0.0,
        light_intensities=1.0 if config.optimize_lights else 0.0,
    )


def fit(init_params: RenderParams, rays, target: torch.Tensor, clip_center,
        clip_direction, light_plans: tuple, light_dims: tuple,
        config: Optional[FitConfig] = None, callback=None,
        return_metrics: bool = False, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1, resume: bool = False):
    """Gradient-descend the render parameters toward ``target``.

    Returns ``(params, losses)``, or ``(params, losses, metrics)`` with
    ``return_metrics=True``: per step a dict of the loss, each leaf's
    gradient norm (``grad_norm/<leaf>``), ``ms_per_step`` (host clock,
    after ``torch.cuda.synchronize()`` when the leaves are on the card) and
    ``rays_per_s``. ``init_params`` is not modified: the fit trains copies.
    ``callback(step, params, loss)`` runs after every step.

    ``checkpoint_dir``: (params, optimizer state) are saved every
    ``checkpoint_every`` steps through `utils.checkpoint.CheckpointManager`;
    with ``resume=True`` a killed fit restarts from the newest checkpoint
    and continues with the same bits (``tests/test_torch_recovery.py``).
    """
    config = config or FitConfig()
    loss_fn = make_loss_fn(rays, target, clip_center, clip_direction,
                           light_plans, light_dims, config)
    params = RenderParams(*(
        torch.as_tensor(getattr(init_params, f), dtype=torch.float32)
        .detach().clone().requires_grad_() for f in FIELDS))
    leaves = [getattr(params, f) for f in FIELDS]
    opt = torch.optim.Adam(leaves, lr=config.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    mask = _param_mask(config)
    on_card = params.volume.device.type == "cuda"

    mgr, start_step = None, 0
    if checkpoint_dir is not None:
        from ..utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)
        if resume and mgr.latest_step() is not None:
            # restored on the CPU: the optimizer moves its moments to the
            # leaves' device and keeps its step counts on the CPU
            (saved, opt_state), meta = mgr.restore(None)
            with torch.no_grad():
                for f in FIELDS:
                    getattr(params, f).copy_(getattr(saved, f))
            opt.load_state_dict(opt_state)
            start_step = int(meta["step"]) + 1

    n_rays = int(np.prod(tuple(rays.thickness.shape)))
    losses, metrics = [], []
    for step in range(start_step, config.steps):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        for f in FIELDS:  # a leaf the loss does not reach: a zero gradient
            leaf = getattr(params, f)
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        gnorms = {"grad_norm/" + f: float(torch.linalg.vector_norm(
            getattr(params, f).grad)) for f in FIELDS}
        with torch.no_grad():
            for f in FIELDS:
                getattr(params, f).grad.mul_(getattr(mask, f))
        opt.step()
        with torch.no_grad():  # keep the TF physical: colours, alpha in [0, 1]
            params.tf_table.clamp_(0.0, 1.0)
            params.window_width.clamp_(min=1e-3)
        loss = float(loss.detach())
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        if return_metrics:
            metrics.append(dict(gnorms, loss=loss, ms_per_step=dt * 1e3,
                                rays_per_s=n_rays / dt))
        if mgr is not None and step % checkpoint_every == 0:
            mgr.save(step, (params, opt.state_dict()))
        if callback is not None:
            callback(step, params, loss)
    if return_metrics:
        return params, losses, metrics
    return params, losses
