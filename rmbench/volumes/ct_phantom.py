"""The benchmark's CT-like volume, made on the device from a seed.

A torch copy of `tbraymarcherplugin_tpu_torch/ops/synthetic.py::
ct_like_phantom` (nested ellipsoids: a body, an organ, a bone shell, plus
Gaussian speckle of sigma 0.015), so that a run makes its volume on the
card in a few calls instead of in numpy on the host. The speckle comes
from a `torch.Generator` on the volume's device seeded with ``seed``; the
shapes are the same for every seed. Made in slabs along X, so that its
temporaries stay small beside the volume.

A Z slab (``z``) is the whole volume's slice bit for bit: the speckle is
drawn for the whole volume (one draw, whose values hang on its shape) and
each X slab's shapes are worked out over the whole Z before the slice.
So a slab costs the whole volume's speckle for a moment; a volume meant
for slabs of a volume that no card holds draws its noise block by block.
"""

from __future__ import annotations

import torch

SLAB = 32  # X slices per slab


def make(dims, seed: int, device, z=None) -> torch.Tensor:
    """(X, Y, Z) float32 volume in [0, 1] on ``device``; with ``z`` =
    (z0, z1) only ``[..., z0:z1]`` of it."""
    dims = tuple(int(d) for d in dims)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    vol = torch.randn(dims, generator=gen, device=device,
                      dtype=torch.float32)
    zs = slice(None) if z is None else slice(int(z[0]), int(z[1]))
    if z is not None:
        vol = vol[..., zs].clone()
    vol.mul_(0.015)
    f32 = torch.float32
    ax = [(torch.arange(d, dtype=f32, device=device) + 0.5) / d - 0.5
          for d in dims]
    py, pz = ax[1][:, None], ax[2][None, :]
    for x0 in range(0, dims[0], SLAB):
        px = ax[0][x0:x0 + SLAB, None, None]

        def norm(cx, cy, cz, sx, sy, sz):
            return torch.sqrt(((px - cx) / sx) ** 2 + ((py - cy) / sy) ** 2
                              + ((pz - cz) / sz) ** 2)

        body = (1.0 - norm(0, 0, 0, 0.45, 0.35, 0.45)).clamp(0.0, 1.0)
        organ = torch.exp(-norm(0.08, 0.02, 0.0, 0.18, 0.18, 0.18) ** 2)
        bone = (1.0 - (norm(0, 0, 0, 0.4, 0.3, 0.42) - 0.9).abs()
                * 12.0).clamp(0.0, 1.0)
        part = 0.25 * (body > 0).to(f32) + 0.3 * organ + 0.45 * bone
        vol[x0:x0 + SLAB] += part[..., zs]
    return vol.clamp_(0.0, 1.0)
