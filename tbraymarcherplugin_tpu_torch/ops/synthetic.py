"""Synthetic test and benchmark volumes (host numpy, made from a seed)."""

from __future__ import annotations

import numpy as np


def ct_like_phantom(dims=(256, 256, 256), seed=0) -> np.ndarray:
    """A CT-ish phantom: nested ellipsoids + speckle, for benchmarks without
    shipping patient data (stands in for the LUNA16 sample volume). Returns
    a float32 (X, Y, Z) array in [0, 1]."""
    uvw = np.stack(
        np.meshgrid(*[np.arange(d) + 0.5 for d in dims], indexing="ij"), -1
    ) / np.asarray(dims)
    p = uvw - 0.5
    rng = np.random.default_rng(seed)
    body = np.clip(
        1.0 - np.linalg.norm(p / np.array([0.45, 0.35, 0.45]), axis=-1), 0, 1
    )
    organ = np.exp(
        -np.linalg.norm((p - [0.08, 0.02, 0.0]) / 0.18, axis=-1) ** 2
    )
    bone = np.clip(
        1.0 - np.abs(
            np.linalg.norm(p / np.array([0.4, 0.3, 0.42]), axis=-1) - 0.9
        ) * 12,
        0,
        1,
    )
    speckle = rng.normal(0.0, 0.015, dims).astype(np.float32)
    vol = 0.25 * (body > 0) + 0.3 * organ + 0.45 * bone + speckle
    return np.clip(vol, 0.0, 1.0).astype(np.float32)


def sphere_volume(dims=(64, 64, 64), center=(0.5, 0.5, 0.5), radius=0.35,
                  softness=0.05) -> np.ndarray:
    """Soft-edged density sphere in [0, 1] (the JAX package's
    `synthetic.sphere_volume`), float32 (X, Y, Z)."""
    grids = np.meshgrid(*[np.arange(d, dtype=np.float32) for d in dims],
                        indexing="ij")
    uvw = (np.stack(grids, axis=-1) + np.float32(0.5)) / np.asarray(
        dims, np.float32)
    d = np.linalg.norm(uvw - np.asarray(center, np.float32), axis=-1)
    return np.clip((radius - d) / softness + 0.5, 0.0, 1.0).astype(np.float32)
