"""Front-to-back emission-absorption compositing (`AccumulateLightEnergy`,
`RaymarchMaterialCommon.usf:82-88`)."""

from __future__ import annotations

import torch

# Accumulated alpha above this terminates a ray; its alpha snaps to 1.0
# (`WindowedRaymarchMaterials.usf:75-79`).
EARLY_TERMINATION_ALPHA = 0.95


def accumulate(energy: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """One over-composite step of (..., 4) RGBA ``sample`` (alpha already
    step-corrected) onto the accumulated (..., 4) ``energy``."""
    trans = 1.0 - energy[..., 3:4]
    rgb = energy[..., :3] + sample[..., :3] * sample[..., 3:4] * trans
    a = energy[..., 3:4] + sample[..., 3:4] * trans
    return torch.cat([rgb, a], dim=-1)


def compose_segments(front: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    """Compose two accumulated (..., 4) RGBA segments front to back. A
    segment's rgb already carries its samples' alphas, so the over operator
    is ``rgb = F.rgb + (1 - F.a) * B.rgb``: the associative operator that
    makes per-slab segment rendering exact (`parallel/slab_sharding.py`)."""
    trans = 1.0 - front[..., 3:4]
    rgb = front[..., :3] + back[..., :3] * trans
    a = front[..., 3:4] + back[..., 3:4] * trans
    return torch.cat([rgb, a], dim=-1)


def accumulate_masked(energy: torch.Tensor, sample: torch.Tensor,
                      active_mask: torch.Tensor) -> torch.Tensor:
    """:func:`accumulate` where ``active_mask`` holds; elsewhere ``energy``
    is kept (the masked form of the shader's ``break``)."""
    return torch.where(active_mask[..., None], accumulate(energy, sample),
                       energy)
