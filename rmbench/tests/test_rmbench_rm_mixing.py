"""The Richtmyer-Meshkov stand-in (`volumes/rm_mixing.py`) and its
blockwise reference (`reference/slab_blocks.py`): any Z slab is the whole
volume's slices bit for bit and every value is k / 255 (on the card too,
where one is), the seed changes the field, the structure is the
dataset's (two pure fluids below the configuration's window, a mixing
layer above it), and the reference's light volume and frame are the
default reference's on a whole volume, bit for bit."""

import dataclasses

import pytest
import torch

from rmbench import harness, volumes
from rmbench.reference import frame as RF
from rmbench.reference import scene as RS
from rmbench.reference import slab_blocks as SB
from rmbench.reference.common import tf_table

SEEDS = [2**31 + 3, 7]
DIMS = (40, 33, 36)  # slabs of 18 and 9


def _slabs_are_the_whole(device, seed):
    make = volumes.load("rm_mixing").make
    whole = make(DIMS, seed, device)
    assert whole.shape == DIMS and whole.dtype == torch.float32
    assert torch.equal(torch.round(whole * 255.0) / 255.0, whole)
    for world in (2, 4):
        for r in range(world):
            z0, z1 = volumes.slab(DIMS, r, world)
            assert torch.equal(make(DIMS, seed, device, z=(z0, z1)),
                               whole[..., z0:z1])
    return whole


@pytest.mark.parametrize("seed", SEEDS)
def test_rm_mixing_slabs_are_the_whole_volumes_slices(seed):
    _slabs_are_the_whole("cpu", seed)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_rm_mixing_slabs_on_the_card(card, seed):
    _slabs_are_the_whole(card, seed)


def test_rm_mixing_structure_and_seed():
    cfg = harness.load_config("richtmyer_meshkov")
    low = cfg["window"][0] - 0.5 * cfg["window"][1]
    make = volumes.load("rm_mixing").make
    v = make((48, 40, 64), SEEDS[0], "cpu")
    # the pure fluids at the ends of Z: uniform, below the window
    for z in (0, 63):
        assert v[..., z].max() < low and v[..., z].min() == v[..., z].max()
    assert v[..., 0].max() != v[..., 63].max()
    # the mixing layer about mid-Z carries values inside the window
    assert (v[..., 28:36] > low).float().mean() > 0.3
    assert not torch.equal(v, make((48, 40, 64), SEEDS[1], "cpu"))


def test_slab_blocks_is_the_default_reference_on_a_whole_volume():
    dims = (24, 20, 32)
    vol = volumes.load("rm_mixing").make(dims, 5, "cpu")
    scene = RF.Scene(volume=vol, table=tf_table("ct_soft_tissue"),
                     window=(0.55, 0.7, 1.0, 1.0),
                     transform=RS.VolumeTransform.create(),
                     lights=(((0.3, 0.1, -0.95), 1.0),),
                     clip=RS.ClipPlane.create([0.0, 0.05, 0.0],
                                              [0.3, -0.8, 0.52]),
                     width=40, height=24, step_count=20)
    from_source = dataclasses.replace(
        scene, volume=volumes.VolumeSource("rm_mixing", dims, 5))
    lv = RF.illumination(scene)
    assert torch.equal(SB.illumination(from_source), lv)
    cam = RS.Camera.look_at((0.9, -2.2, 0.6), (0, 0, 0), fov_degrees=35.0)
    stats = {}
    got = SB.frame(from_source, cam, lv, 2, stats=stats)
    assert torch.equal(got, RF.frame(scene, cam, lv, 2))
    assert set(stats["bands"]) == {2, 4}
    assert 0 < stats["bands"][4]["samples"] < stats["samples"]


def test_slab_blocks_refuses_what_is_not_k_over_255():
    dims = (8, 8, 8)
    src = volumes.VolumeSource("ct_phantom", dims, 5)
    scene = RF.Scene(volume=src, table=tf_table("ct_soft_tissue"),
                     window=(0.5, 0.5, 1.0, 1.0),
                     transform=RS.VolumeTransform.create(),
                     lights=(((0.3, 0.1, -0.95), 1.0),),
                     clip=RS.ClipPlane.disabled(), width=8, height=8)
    with pytest.raises(ValueError, match="k / 255"):
        SB.illumination(scene)
