"""Model families of the port: the functional, differentiable lit pipeline
(:mod:`.pipeline`). Fitting (`models/fitting.py` of the JAX package) comes
with a later slice."""

from .pipeline import LightPlan, RenderParams, compute_illumination, render_lit_scene

__all__ = ["LightPlan", "RenderParams", "compute_illumination",
           "render_lit_scene"]
