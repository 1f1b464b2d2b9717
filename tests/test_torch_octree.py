"""The port's min/max pyramid and occupancy grid (`ops/octree.py`) against
the JAX package's, on the same numpy volume: the pyramids and the grid
must be equal exactly (max/min of the same float32 values; the interval
test is the same float32 arithmetic)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tbraymarcherplugin_tpu.ops import octree as JO
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch.ops import octree as PO
from tbraymarcherplugin_tpu_torch.ops import synthetic

# A non-monotone TF: alpha rises, falls to exactly 0, rises again.
NON_MONOTONE = ([0.0, 0.2, 0.35, 0.5, 0.65, 1.0],
                [[0, 0, 0, 0], [1, 0, 0, 0.6], [0, 0, 0, 0], [0, 0, 0, 0],
                 [0, 1, 0, 0.8], [0, 0, 1, 0]])


def test_build_octree_matches_jax():
    vol = synthetic.ct_like_phantom((20, 13, 9), seed=1)
    want = JO.build_octree(jnp.asarray(vol), max_value=0.8)
    got = PO.build_octree(torch.from_numpy(vol), max_value=0.8)
    assert got.data_dims == tuple(want.data_dims) == (20, 13, 9)
    for gm, wm in zip(got.mips + got.min_mips, want.mips + want.min_mips):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("tf_name", ["bone", "non_monotone"])
@pytest.mark.parametrize("win", [(0.5, 0.8, 1.0, 1.0), (0.35, 0.3, 1.0, 0.0),
                                 (0.6, 0.5, 0.0, 0.0)])
def test_occupancy_grid_equals_jax(tf_name, win):
    """The port's grid holds every cell of the JAX package's (its ranges
    are widened by ``LERP_MARGIN`` against the lerps' rounding) and, on
    this volume, no other."""
    vol = synthetic.ct_like_phantom((33, 40, 30), seed=2)
    vol[:, :24] = 0.0  # an empty slab, so that some cells are empty
    tf = (JT.tf_ct_bone() if tf_name == "bone"
          else JT.tf_from_keypoints(*NON_MONOTONE))
    win_j = jnp.asarray(win, jnp.float32)
    for mip in (1, 2, 3):
        want = JO.occupancy_grid(JO.build_octree(jnp.asarray(vol)), win_j,
                                 tf, mip=mip)
        got = PO.occupancy_grid(PO.build_octree(torch.from_numpy(vol)),
                                torch.tensor(win), torch.from_numpy(
                                    np.array(tf)), mip=mip)
        want_grid = np.asarray(want.grid)
        assert not (want_grid & ~got.grid.numpy()).any()  # a superset
        np.testing.assert_array_equal(got.grid.numpy(), want_grid)
        assert got.cell_scale == tuple(want.cell_scale)
    assert 0 < int(got.grid.sum()) < got.grid.numel()


def test_occupancy_grid_rejects_mip_0():
    oc = PO.build_octree(torch.zeros((8, 8, 8)))
    with pytest.raises(ValueError, match="mip must be >= 1"):
        PO.occupancy_grid(oc, torch.tensor([0.5, 1.0, 1.0, 1.0]),
                          torch.ones((256, 4)), mip=0)


def test_load_mip_nearest_matches_jax(rng):
    """Truncation toward zero and per-axis clamping, exactly: positions
    around and outside the mip's extent, negative ones included."""
    mip = rng.random((9, 6, 5), dtype=np.float32)
    pos = (rng.random((500, 3)) * [13.0, 10.0, 9.0] - [2.0, 2.0, 2.0]
           ).astype(np.float32)
    want = np.asarray(JO.load_mip_nearest(jnp.asarray(mip), jnp.asarray(pos)))
    got = PO.load_mip_nearest(torch.from_numpy(mip), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


# the octree march: a non-pow2 volume, so that the z rescale of the padded
# mips is exercised; the JAX march's own tolerances
OCTREE_DIMS = (30, 26, 21)
OCTREE_CLIP = ([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])
NO_CLIP = ([0.0, 0.0, -1e6], [0.0, 0.0, 1.0])


@pytest.mark.parametrize("mip", [0, 1])
@pytest.mark.parametrize("clip,jitter", [(NO_CLIP, False),
                                         (OCTREE_CLIP, True)])
def test_march_octree_matches_jax(mip, clip, jitter):
    from tbraymarcherplugin_tpu import scene as JS
    from tbraymarcherplugin_tpu.ops import rays as JR
    from tbraymarcherplugin_tpu_torch.ops import rays as PR

    vol = synthetic.ct_like_phantom(OCTREE_DIMS, seed=4)
    tf = np.array(JT.tf_ct_bone())
    win = np.asarray([0.5, 0.8, 1.0, 1.0], np.float32)
    cam = JS.Camera.look_at((0.3, -2.4, 0.5), (0.0, 0.0, 0.0),
                            fov_degrees=30.0)
    rays = tuple(np.asarray(x) for x in JR.setup_rays(
        cam, JS.VolumeTransform.create(), 40, 32))
    jit = np.asarray(JR.jitter_values(40, 32, 5)) if jitter else None
    cc, cd = (np.float32(x) for x in clip)
    want = np.asarray(JO.march_octree(
        JO.build_octree(jnp.asarray(vol)), jnp.asarray(tf),
        JR.RayBatch(*(jnp.asarray(x) for x in rays)), jnp.asarray(win),
        jnp.asarray(cc), jnp.asarray(cd),
        jitter=None if jit is None else jnp.asarray(jit), step_count=40,
        mip=mip))
    got = PO.march_octree(
        PO.build_octree(torch.from_numpy(vol)), torch.from_numpy(tf),
        PR.RayBatch(*(torch.from_numpy(np.array(x)) for x in rays)),
        torch.from_numpy(win), cc, cd,
        jitter=None if jit is None else torch.from_numpy(np.array(jit)),
        step_count=40, mip=mip).numpy()
    assert got.shape == (32, 40, 4) and np.isfinite(got).all()
    assert want[..., 3].max() > 0.5
    if jitter:
        assert (want[..., 3] == 1.0).any()  # the termination snap ran
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
