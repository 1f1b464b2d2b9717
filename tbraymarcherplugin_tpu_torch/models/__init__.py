"""Model families of the port: the functional, differentiable lit pipeline
(:mod:`.pipeline`) and the inverse-rendering loop on it
(:mod:`.fitting`)."""

from .fitting import FitConfig, fit
from .pipeline import LightPlan, RenderParams, compute_illumination, render_lit_scene

__all__ = ["FitConfig", "LightPlan", "RenderParams", "compute_illumination",
           "fit", "render_lit_scene"]
