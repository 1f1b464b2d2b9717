"""A seeded stand-in for the Richtmyer-Meshkov entropy field (Open SciVis
`richtmyer_meshkov`: LLNL's simulation of the instability, Cohen et al.,
Physics of Fluids 14, 2002; 2048x2048x1920 uint8 on an isotropic grid),
made on the device from a seed.

Its structure is the dataset's: a heavy fluid below and a light fluid
above an interface at mid-Z, the interface perturbed by seeded modes at
two scales (the simulation's two-scale initial perturbation), and a
mixing layer about a quarter of Z thick between them, filled with seeded
multi-octave noise, where the entropy is high; the pure fluids hold low,
nearly uniform values. Every value is k / 255, the dataset's uint8.

Every voxel is a function of (x, y, z, seed) alone: the interface is a
function of (x, y), worked out on the host for the whole (X, Y) plane,
and the noise is hashed lattice noise (integer hashes of the lattice
corners, smoothstep-lerped), so any Z slab is made alone, bit for bit the
whole volume's slices, and per voxel only additions, multiplications,
floors and clamps run on the device. Made in Z blocks, so that its
temporaries stay small beside the volume.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 16  # Z planes made at a time
LAYER = 0.25  # the mixing layer's thickness, a share of Z
OCTAVES = ((64, 1.0), (32, 0.5), (16, 0.25), (8, 0.125))  # (voxels, weight)
# the pure fluids' values and the mixing layer's peak (entropy, k / 255)
LIGHT, HEAVY, PEAK = 0.05, 0.12, 0.85
_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=2)
def _interface(dims, seed: int) -> np.ndarray:
    """(X, Y) float64 height of the interface, a share of Z: 0.5 plus
    seeded long-wavelength modes (1-4 waves across) and short ones (16-32
    waves), the two scales of the initial perturbation. Kept for the next
    slab of the same volume (a reference makes it block by block)."""
    rng = np.random.default_rng(int(seed))
    u = (np.arange(dims[0]) + 0.5) / dims[0]
    v = (np.arange(dims[1]) + 0.5) / dims[1]
    h = np.full((dims[0], dims[1]), 0.5)
    for count, waves, amp in ((6, (1, 5), 0.03), (12, (16, 33), 0.006)):
        kx = rng.integers(*waves, size=count)
        ky = rng.integers(*waves, size=count)
        phase = rng.uniform(0.0, 2.0 * np.pi, size=count)
        a = amp * rng.uniform(0.5, 1.0, size=count)
        for i in range(count):
            h += a[i] * np.cos(2.0 * np.pi * (kx[i] * u[:, None]
                                              + ky[i] * v[None, :])
                               + phase[i])
    return h


def _hash(ix, iy, iz, seed: int, octave: int) -> torch.Tensor:
    """Uniform values in [-1, 1) of integer lattice corners (int64
    tensors that broadcast), from a 32-bit integer hash."""
    h = ((ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)
         ^ (int(seed) & _MASK) ^ ((int(seed) >> 32) * 2654435761 & _MASK)
         ^ (octave * 668265263)) & _MASK
    for _ in range(2):
        h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) * (2.0 / 16777216.0) - 1.0


def _fade(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def _axis(n: int, lo: int, hi: int, step: int, device):
    """Lattice cell and smoothstep weight of voxels lo .. hi - 1 along an
    axis of lattice spacing ``step``."""
    i = torch.arange(lo, hi, device=device)
    cell = torch.div(i, step, rounding_mode="floor")
    frac = ((i - cell * step).to(torch.float32) + 0.5) * (1.0 / step)
    return cell, _fade(frac)


def _noise(dims, seed: int, z0: int, z1: int, device) -> torch.Tensor:
    """(X, Y, z1 - z0) multi-octave lattice noise of planes z0 .. z1 - 1,
    about in [-1, 1]: per octave the lattice's hashed values lerped along
    x, then y, then z."""
    X, Y, _ = dims
    total = None
    for o, (step, weight) in enumerate(OCTAVES):
        cx, fx = _axis(X, 0, X, step, device)
        cy, fy = _axis(Y, 0, Y, step, device)
        cz, fz = _axis(dims[2], z0, z1, step, device)
        lx = torch.arange(int(cx.max()) + 2, device=device)
        ly = torch.arange(int(cy.max()) + 2, device=device)
        lz = torch.arange(int(cz.min()), int(cz.max()) + 2, device=device)
        lat = _hash(lx[:, None, None], ly[None, :, None], lz[None, None, :],
                    seed, o)
        a = lat[cx]  # along x: (X, LY, LZ)
        a = a + (lat[cx + 1] - a) * fx[:, None, None]
        b = a[:, cy]  # along y: (X, Y, LZ)
        b = b + (a[:, cy + 1] - b) * fy[None, :, None]
        iz = cz - int(cz.min())
        c = b[:, :, iz]  # along z: (X, Y, z1 - z0)
        c = c + (b[:, :, iz + 1] - c) * fz[None, None, :]
        total = c * weight if total is None else total + c * weight
    return total


def make(dims, seed: int, device, z=None) -> torch.Tensor:
    """(X, Y, Z) float32 volume of values k / 255 on ``device``; with ``z``
    = (z0, z1) only ``[..., z0:z1]`` of it."""
    dims = tuple(int(d) for d in dims)
    z0, z1 = (0, dims[2]) if z is None else (int(z[0]), int(z[1]))
    f32 = torch.float32
    height = torch.from_numpy(_interface(dims, int(seed)).astype(
        np.float32)).to(device)[:, :, None]
    half = np.float32(0.5 * LAYER)
    out = torch.empty((dims[0], dims[1], z1 - z0), dtype=f32, device=device)
    for a in range(z0, z1, BLOCK):
        b = min(a + BLOCK, z1)
        w = (torch.arange(a, b, device=device).to(f32) + 0.5) * (
            1.0 / dims[2])
        s = (w[None, None, :] - height) * (1.0 / half)  # layer half-widths
        heavy = (0.5 - 0.5 * s).clamp(0.0, 1.0)  # the heavy fluid's share
        inside = (1.0 - s * s).clamp(min=0.0)  # the layer's envelope
        n = _noise(dims, seed, a, b, device)
        c = (heavy + 0.6 * inside * n).clamp(0.0, 1.0)
        mixed = 4.0 * c * (1.0 - c) * (0.75 + 0.25 * n)
        v = LIGHT + (HEAVY - LIGHT) * c + PEAK * mixed.clamp(0.0, 1.0)
        q = torch.floor(v * 255.0 + 0.5).clamp(0.0, 255.0)
        out[:, :, a - z0:b - z0] = q / 255.0
    return out
