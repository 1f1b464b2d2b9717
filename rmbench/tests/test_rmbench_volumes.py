"""The volumes found by file (`volumes/<name>.py`): `ct_phantom` makes the
bits it made before it moved there, for every seed, and its Z slabs are
the whole volume's slices bit for bit, whatever the split."""

import pytest
import torch

from rmbench import harness, phantom, volumes

SEEDS = [2**31 + 3, 7]


def _before_the_move(dims, seed, device):
    """`phantom.ct_phantom` as it was before it moved to `volumes/`."""
    dims = tuple(int(d) for d in dims)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    vol = torch.randn(dims, generator=gen, device=device,
                      dtype=torch.float32)
    vol.mul_(0.015)
    f32 = torch.float32
    ax = [(torch.arange(d, dtype=f32, device=device) + 0.5) / d - 0.5
          for d in dims]
    py, pz = ax[1][:, None], ax[2][None, :]
    for x0 in range(0, dims[0], 32):
        px = ax[0][x0:x0 + 32, None, None]

        def norm(cx, cy, cz, sx, sy, sz):
            return torch.sqrt(((px - cx) / sx) ** 2 + ((py - cy) / sy) ** 2
                              + ((pz - cz) / sz) ** 2)

        body = (1.0 - norm(0, 0, 0, 0.45, 0.35, 0.45)).clamp(0.0, 1.0)
        organ = torch.exp(-norm(0.08, 0.02, 0.0, 0.18, 0.18, 0.18) ** 2)
        bone = (1.0 - (norm(0, 0, 0, 0.4, 0.3, 0.42) - 0.9).abs()
                * 12.0).clamp(0.0, 1.0)
        part = 0.25 * (body > 0).to(f32) + 0.3 * organ + 0.45 * bone
        vol[x0:x0 + 32] += part
    return vol.clamp_(0.0, 1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_ct_phantom_keeps_its_bits(seed):
    dims = (70, 33, 20)  # three X slabs, the last a part
    make = volumes.load("ct_phantom").make
    assert torch.equal(make(dims, seed, "cpu"),
                       _before_the_move(dims, seed, "cpu"))
    assert torch.equal(phantom.ct_phantom(dims, seed, "cpu"),
                       make(dims, seed, "cpu"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_ct_phantom_slabs_are_the_whole_volumes_slices(seed, world):
    dims = (40, 33, 36)  # slabs of 18 and 9: vector tails of every length
    make = volumes.load("ct_phantom").make
    whole = make(dims, seed, "cpu")
    for r in range(world):
        z0, z1 = volumes.slab(dims, r, world)
        assert (z0, z1) == (r * 36 // world, (r + 1) * 36 // world)
        part = make(dims, seed, "cpu", z=(z0, z1))
        assert part.is_contiguous() and part.shape == (40, 33, z1 - z0)
        assert torch.equal(part, whole[..., z0:z1])


def test_a_z_the_ranks_do_not_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        volumes.slab((8, 8, 10), 0, 4)


def test_a_volume_source_makes_the_volume_and_its_blocks():
    src = volumes.VolumeSource("ct_phantom", (16, 12, 8), 5)
    whole = src.make("cpu")
    assert src.shape == (16, 12, 8)
    assert torch.equal(whole, phantom.ct_phantom((16, 12, 8), 5, "cpu"))
    assert torch.equal(src.make("cpu", z=(2, 6)), whole[..., 2:6])


def test_volumes_and_references_are_found_by_name():
    cfg = harness.load_config("ct256_bone")
    assert harness.load_reference(cfg).__name__ == "rmbench.reference.frame"
    whole = harness.load_reference(dict(cfg, reference="whole"))
    assert callable(whole.illumination) and callable(whole.frame)
    with pytest.raises(KeyError, match="no volume"):
        volumes.load("no_such_volume")
    with pytest.raises(KeyError, match="no reference"):
        harness.load_reference(dict(cfg, reference="no_such_reference"))
