"""The port's ray marches (`ops/march.py`) and their depth path
(`ops/rays.py` scene depth, `ops/sampling.py` clip and windowing) against
the JAX package's, on the same numpy inputs.

The scenes are the JAX march tests' (`tests/test_march.py`,
`tests/test_pallas_march.py`): a 33x28x17 sphere with a 16x14x8 light
volume, 40x40 rays, 24-50 steps, a clip plane, cutoffs and jitter.
Tolerances: atol 2e-5 against the JAX function that does the same
operations in the same order (what remains is the sum order of XLA's and
PyTorch's reductions and of the clip plane's dot product).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import march as JM
from tbraymarcherplugin_tpu.ops import octree as JO
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import sampling as JSa
from tbraymarcherplugin_tpu.ops import synthetic as JSyn
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import march as PM
from tbraymarcherplugin_tpu_torch.ops import octree as PO
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import sampling as PSa

SAME_ORDER_ATOL = 2e-5
CAM = ((0.3, -2.4, 0.5), (0.0, 0.0, 0.0))
CLIP = ([0.5, 0.5, 0.5], [0.1, 0.2, 0.97])
NO_CLIP = ([0.0, 0.0, -1e6], [0.0, 0.0, 1.0])
RAMP = [[0, 0, 0, 0], [1, 1, 1, 1]]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scene(img=(40, 40), light_dims=(16, 14, 8), clip=CLIP,
           win=(0.6, 0.5, 1.0, 0.0), frame=3):
    """numpy inputs: volume, TF, light volume, rays (entry, direction,
    thickness), window, clip center and direction, jitter."""
    vol = np.asarray(JSyn.sphere_volume((33, 28, 17), radius=0.4))
    lv = np.random.default_rng(7).random(light_dims, np.float32)
    cam = JS.Camera.look_at(*CAM, fov_degrees=30.0)
    rays = JR.setup_rays(cam, JS.VolumeTransform.create(), *img)
    jit = None if frame is None else np.asarray(
        JR.jitter_values(img[0], img[1], frame))
    return dict(vol=vol, tf=np.asarray(JT.tf_from_keypoints([0, 1], RAMP)),
                lv=lv, rays=tuple(np.asarray(x) for x in rays),
                win=np.asarray(win, np.float32), cc=np.float32(clip[0]),
                cd=np.float32(clip[1]), jit=jit)


def _jax(fn, s, **kw):
    rays = JR.RayBatch(*(jnp.asarray(x) for x in s["rays"]))
    jit = None if s["jit"] is None else jnp.asarray(s["jit"])
    return np.asarray(fn(jnp.asarray(s["vol"]), jnp.asarray(s["tf"]),
                         jnp.asarray(s["lv"]), rays, jnp.asarray(s["win"]),
                         jnp.asarray(s["cc"]), jnp.asarray(s["cd"]),
                         jitter=jit, **kw))


def _port(fn, s, **kw):
    rays = PR.RayBatch(*(_t(x) for x in s["rays"]))
    jit = None if s["jit"] is None else _t(s["jit"])
    return fn(_t(s["vol"]), _t(s["tf"]), _t(s["lv"]), rays, _t(s["win"]),
              s["cc"], s["cd"], jitter=jit, **kw).numpy()


def _close(got, want, atol=SAME_ORDER_ATOL):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want[..., 3].max() > 0.5  # the scene renders
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["plain", "clip_cutoffs_jitter"])
def test_march_lit_matches_jax(case):
    s = (_scene(clip=NO_CLIP, win=(0.5, 1.0, 1.0, 1.0), frame=None)
         if case == "plain" else _scene())
    kw = dict(step_count=24)
    _close(_port(PM.march_lit, s, **kw), _jax(JM.march_lit, s, **kw))


@pytest.mark.parametrize("compat", [True, False])
def test_march_lit_compat_final_step_matches_jax(compat):
    # translucent everywhere, so rays run to the final fractional step
    s = _scene(clip=NO_CLIP, win=(0.5, 1.0, 1.0, 1.0))
    s["vol"] = np.full((16, 16, 16), 0.3, np.float32)
    s["tf"] = np.asarray(JT.tf_from_keypoints(
        [0.0, 1.0], [[0, 0, 0, 0], [1.0, 1.0, 1.0, 0.05]]))
    kw = dict(step_count=33, compat_final_step=compat)
    _close(_port(PM.march_lit, s, **kw), _jax(JM.march_lit, s, **kw))


@pytest.mark.parametrize("block_size", [7, 32])
def test_march_lit_blocked_matches_jax(block_size):
    s = _scene()
    kw = dict(step_count=40, block_size=block_size)
    _close(_port(PM.march_lit_blocked, s, **kw),
           _jax(JM.march_lit_blocked, s, **kw))


@pytest.mark.parametrize("tiling", [dict(tile_size=300),
                                    dict(tile2d=(9, 8), tile_size=200)])
def test_march_lit_tiled_matches_jax_and_blocked(tiling):
    """Each ray's result equals the blocked march's, whatever the tiling
    (a 40x40 image in 9x8 tiles does not divide evenly)."""
    s = _scene()
    kw = dict(step_count=40, block_size=16)
    got = _port(PM.march_lit_tiled, s, **tiling, **kw)
    np.testing.assert_array_equal(got, _port(PM.march_lit_blocked, s, **kw))
    _close(got, _jax(JM.march_lit_tiled, s, **tiling, **kw))


def test_march_intensity_matches_jax():
    s = _scene(win=(0.5, 0.8, 1.0, 1.0))
    kw = dict(step_count=50)

    def port(*a, **k):
        return PM.march_intensity(a[0], *a[3:], **k)

    def jax_(*a, **k):
        return JM.march_intensity(a[0], *a[3:], **k)

    got, want = _port(port, s, **kw), _jax(jax_, s, **kw)
    assert want[..., 3].max() == 1.0  # something was hit
    np.testing.assert_allclose(got, want, rtol=0, atol=SAME_ORDER_ATOL)


def test_skip_blocks_with_occupancy_grid_matches_jax(rng):
    """Empty-space skipping on a sparse scene: the same image as the JAX
    package's skipping march and, exactly, as the port's march without
    skipping."""
    s = _scene(clip=NO_CLIP, win=(0.5, 1.0, 1.0, 1.0))
    vol = np.zeros((33, 32, 30), np.float32)  # non-pow2: padding cells
    vol[4:12, 4:12, 4:12] = rng.random((8, 8, 8), dtype=np.float32)
    s["vol"] = vol
    jog = JO.occupancy_grid(JO.build_octree(jnp.asarray(vol)),
                            jnp.asarray(s["win"]), jnp.asarray(s["tf"]), mip=2)
    pog = PO.occupancy_grid(PO.build_octree(_t(vol)), _t(s["win"]),
                            _t(s["tf"]), mip=2)
    np.testing.assert_array_equal(pog.grid.numpy(), np.asarray(jog.grid))
    assert pog.cell_scale == jog.cell_scale
    assert 0 < int(pog.grid.sum()) < pog.grid.numel()  # some cells skip
    kw = dict(step_count=50, block_size=16)
    got = _port(PM.march_lit_blocked, s, occ_grid=pog.grid,
                occ_scale=pog.cell_scale, skip_blocks=True, **kw)
    np.testing.assert_array_equal(got, _port(PM.march_lit_blocked, s, **kw))
    want = _jax(JM.march_lit_blocked, s, occ_grid=jog.grid,
                occ_scale=jog.cell_scale, skip_blocks=True, **kw)
    assert want[..., 3].max() > 0.1  # the blob renders
    np.testing.assert_allclose(got, want, rtol=0, atol=SAME_ORDER_ATOL)


def test_scene_depth_rays_and_march_match_jax():
    """An opaque plane through the volume: its depth, the clamped rays and
    the march of them."""
    jcam = JS.Camera.look_at(*CAM, fov_degrees=30.0)
    pcam = PS.Camera.look_at(*CAM, fov_degrees=30.0)
    jtr = JS.VolumeTransform.create(scale=(1.2, 0.9, 1.0))
    ptr = PS.VolumeTransform.create(scale=(1.2, 0.9, 1.0))
    plane = ((0.05, 0.1, 0.0), (0.2, -1.0, 0.3))
    want_d = np.asarray(JR.scene_depth_from_plane(jcam, jtr, 40, 30, *plane))
    got_d = PR.scene_depth_from_plane(pcam, ptr, 40, 30, *plane).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
    assert np.isfinite(want_d).any()
    want = JR.setup_rays(jcam, jtr, 40, 30, scene_depth=jnp.asarray(want_d))
    got = PR.setup_rays(pcam, ptr, 40, 30, scene_depth=got_d)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    full = PR.setup_rays(pcam, ptr, 40, 30)
    assert (got.thickness < full.thickness - 1e-3).any()  # the plane cut
    s = _scene()
    s["rays"] = tuple(np.asarray(x) for x in want)
    s["jit"] = None
    _close(_port(PM.march_lit_blocked, s, step_count=40),
           _jax(JM.march_lit_blocked, s, step_count=40))


def test_sampling_clip_and_window_position_match_jax(rng):
    uvw = rng.random((500, 3), dtype=np.float32) * 1.4 - 0.2
    got = PSa.is_clipped(_t(uvw), CLIP[0], CLIP[1]).numpy()
    want = np.asarray(JSa.is_clipped(jnp.asarray(uvw), jnp.float32(CLIP[0]),
                                     jnp.float32(CLIP[1])))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    v = rng.random(500, dtype=np.float32)
    np.testing.assert_array_equal(
        PSa.transfer_func_position(_t(v), 0.45, 0.7).numpy(),
        np.asarray(JSa.transfer_func_position(jnp.asarray(v), jnp.float32(0.45),
                                              jnp.float32(0.7))))
