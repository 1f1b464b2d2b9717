"""The volumes a configuration may name, one file each.

A configuration's ``volume`` names ``volumes/<name>.py``, which exposes
``make(dims, seed, device, z=None)``: the (X, Y, Z) float32 volume made
on ``device`` from the seed, or with ``z`` = (z0, z1) the slab
``whole[..., z0:z1]`` of it, bit for bit whatever the split.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The module of ``volumes/<name>.py``."""
    if not (HERE / f"{name}.py").exists():
        raise KeyError(f"no volume {name!r}: rmbench/volumes/{name}.py")
    return importlib.import_module(f"{__name__}.{name}")


def slab(dims, rank: int, world: int) -> tuple:
    """Rank ``rank``'s Z slab of ``world``: [r*Z/n, (r+1)*Z/n)."""
    z = int(dims[2])
    if z % world:
        raise ValueError(f"Z = {z} does not split into {world} equal slabs")
    return rank * z // world, (rank + 1) * z // world


@dataclasses.dataclass(frozen=True)
class VolumeSource:
    """A volume that the reference makes itself, whole or block by block
    along Z: what the check hands a sharded configuration's reference in
    place of a tensor (no card holds the whole volume)."""

    name: str
    dims: tuple
    seed: int

    @property
    def shape(self) -> tuple:
        return self.dims

    def make(self, device, z=None):
        return load(self.name).make(self.dims, self.seed, device, z=z)
