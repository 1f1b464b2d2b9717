"""The slice as a whole: the port's `Renderer` on the CPU (every kernel's
plain version) vs the JAX package's `Renderer`, from the same state carried
across by `convert.to_port_state`: shear-warp frames in the three render
modes, with and without a scene-depth map, and march frames for a camera
inside the volume. The JAX `Renderer` takes its shear-warp path only on an
accelerator, so the port's shear-warp frames are held against the JAX
functions that path calls, composed by hand with float32 planes."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu import renderer as JRm
from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import octree as JO
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.pallas_warp import warp_to_screen_fused
from tbraymarcherplugin_tpu.ops.shearwarp_pallas import (
    shearwarp_intermediate_fused,
)
from tbraymarcherplugin_tpu.utils.volume_info import WindowingParameters
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.convert import to_port_state
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig

DIMS = (24, 24, 24)
W, H = 64, 48
STEPS = 20
LIGHT = (0.3, 0.1, -0.95)
MOVED = (0.1, 0.4, -0.9)
CAM = ((0.1, -2.3, 0.4), (0.0, 0.0, 0.0))
# inside the volume's dominant slab: no shear-warp plan, the frame marches
INSIDE = ((0.1, -0.3, 0.05), (0.0, 0.0, 0.0))
# K9 against the JAX package's step-by-step march_lit: the JAX fused march's
# own tolerance (tests/test_pallas_march.py); the JAX Renderer's "pallas"
# path needs a TPU, and K9 takes march_lit's semantics with the blocked
# march's sample positions
MARCH_RTOL, MARCH_ATOL = 1e-4, 5e-5


def _jax_renderer(jitter=False, **cfg):
    vol = jnp.asarray(synthetic.ct_like_phantom(DIMS, seed=0))
    cfg.setdefault("march_impl", "shearwarp")
    r = JRm.Renderer(
        vol, tf_table=JT.tf_ct_bone(),
        windowing=WindowingParameters(center=0.5, width=0.8),
        config=JRm.RendererConfig(step_count=STEPS, jitter=jitter, **cfg),
    )
    r.add_light("sun", JS.DirLight.create(LIGHT, 1.0))
    return r


def _state(jr, cam):
    """The JAX renderer's state as numpy arrays."""
    names = list(jr.lights)
    return dict(
        volume=np.asarray(jr.volume), tf_table=np.asarray(jr.tf_table),
        light_volume=np.asarray(jr.light_volume),
        windowing=np.asarray(jr.windowing.as_vec4()),
        light_directions=np.stack(
            [np.asarray(jr.lights[n].direction) for n in names]),
        light_intensities=np.asarray(
            [np.asarray(jr.lights[n].intensity) for n in names]),
        camera_position=np.asarray(cam.position),
        camera_rotation=np.asarray(cam.rotation),
        camera_tan_half_fov=np.asarray(cam.tan_half_fov),
        clip_center=np.asarray(jr.clip_plane.center),
        clip_direction=np.asarray(jr.clip_plane.direction),
        transform_rotation=np.asarray(jr.transform.rotation),
        transform_translation=np.asarray(jr.transform.translation),
        transform_scale=np.asarray(jr.transform.scale),
    ), names


def _port_renderer(jr, cam, jitter=False, **cfg):
    arrays, names = _state(jr, cam)
    st = to_port_state(arrays, device="cpu")
    cfg.setdefault("march_impl", "shearwarp")
    r = Renderer(st["volume"], tf_table=st["tf_table"],
                 windowing=st["windowing"], transform=st["transform"],
                 clip_plane=st["clip_plane"],
                 config=RendererConfig(step_count=STEPS, jitter=jitter,
                                       **cfg), device="cpu")
    r.light_volume = st["light_volume"]
    for name, light in zip(names, st["lights"]):
        r.add_light(name, light)
    return r, st["camera"]


def test_slice_matches_jax_renderer():
    """One rebuild, two orbit frames, one light move (selective update)."""
    jr = _jax_renderer()
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, pcam = _port_renderer(jr, jcam)
    jcams = [jcam, JS.orbit_camera(-1.2, 2.3, 0.5, fov_degrees=40.0)]
    pcams = [pcam, PS.orbit_camera(-1.2, 2.3, 0.5, fov_degrees=40.0)]
    for step, (jc, pc) in enumerate(zip(jcams, pcams)):
        want = np.asarray(jr.render(jc, W, H))
        got = port.render(pc, W, H).numpy()
        assert got.shape == (H, W, 4) and np.isfinite(got).all()
        assert want[..., 3].max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"frame {step}")
    np.testing.assert_allclose(port.light_volume.numpy(),
                               np.asarray(jr.light_volume), rtol=0, atol=1e-5)
    jr.update_light("sun", JS.DirLight.create(MOVED, 0.8))
    port.update_light("sun", PS.DirLight.create(MOVED, 0.8))
    want = np.asarray(jr.render(jcams[1], W, H))
    got = port.render(pcams[1], W, H).numpy()
    assert not port._lights_dirty
    np.testing.assert_allclose(port.light_volume.numpy(),
                               np.asarray(jr.light_volume), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_jittered_frame_matches_jax_fused_path():
    """With jitter on, the port renders what the JAX package's accelerator
    path computes: the fused composite with `jitter_values(n2, n1, frame)`
    and the channel-major fused warp."""
    jr = _jax_renderer()
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, pcam = _port_renderer(jr, jcam, jitter=True)
    got = port.render(pcam, W, H).numpy()
    got2 = port.render(pcam, W, H).numpy()
    jr.ensure_lighting()
    plan = JSW.plan_shearwarp(jcam, jr.transform, DIMS, DIMS, W, H,
                              max_planes=STEPS)
    clip = jr.transform.local_clip_plane(jr.clip_plane)
    inter = shearwarp_intermediate_fused(
        jr.volume, jr.tf_table, jr.light_volume, plan, jr.windowing.as_vec4(),
        clip.center, clip.direction, compute_dtype=jnp.float32,
        jitter=JR.jitter_values(plan.n2, plan.n1, 0), out_layout="chw",
    )
    want = np.asarray(warp_to_screen_fused(inter, plan, W, H,
                                           channel_major=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert port._frame_index == 2 and not np.array_equal(got, got2)


@pytest.mark.parametrize("cfg", [dict(light_volume_half_resolution=True),
                                 dict(light_volume_32bit=False),
                                 dict(apply_write_threshold=False)])
def test_light_volume_configs_match_jax(cfg):
    jr = _jax_renderer(**cfg)
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, _ = _port_renderer(jr, jcam, **cfg)
    jr.ensure_lighting()
    port.ensure_lighting()
    assert tuple(port.light_volume.shape) == tuple(jr.light_volume.shape)
    np.testing.assert_allclose(port.light_volume.numpy(),
                               np.asarray(jr.light_volume), rtol=0,
                               atol=1e-5 if cfg.get("light_volume_32bit", True)
                               else 1 / 255 + 1e-6)


def test_dirty_flags_and_remove_light():
    jr = _jax_renderer(apply_write_threshold=False)
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, pcam = _port_renderer(jr, jcam, apply_write_threshold=False)
    port.render(pcam, W, H)
    lv = port.light_volume
    port.render(pcam, W, H)
    assert port.light_volume is lv  # unchanged scene: no rebuild
    port.set_window_width(0.5)
    assert port._lights_dirty
    port.render(pcam, W, H)
    assert not torch.equal(port.light_volume, lv)
    port.set_window_width(0.8)
    port.add_light("fill", PS.DirLight.create((1.0, 0.0, 0.0), 0.4))
    port.ensure_lighting()
    port.remove_light("fill")
    jr.ensure_lighting()
    np.testing.assert_allclose(port.light_volume.numpy(),
                               np.asarray(jr.light_volume), rtol=0, atol=1e-5)


def _jax_frame(jr, jcam, mode="lit", mip=0, scene_depth=None, frame=0):
    """What the JAX package's accelerator path renders for ``jr``'s state
    (`renderer.py::_render_shearwarp`, `_render_shearwarp_mode`): the fused
    composite on float32 planes, jitter of frame ``frame``, the
    channel-major fused warp."""
    jr.ensure_lighting()  # lit mode only
    vol, light = jr.volume, jr.light_volume
    if mode == "octree":
        oc = JO.build_octree(jr.volume, max_value=1.0)
        arr = oc.mips[mip]
        z_eff = max(1, -(-arr.shape[2] * oc.data_dims[2]
                         // oc.mips[0].shape[2]))
        vol = light = arr[:, :, :z_eff]
    elif mode == "intensity":
        light = vol
    plan = JSW.plan_shearwarp(jcam, jr.transform, vol.shape, light.shape, W,
                              H, max_planes=STEPS)
    clip = jr.transform.local_clip_plane(jr.clip_plane)
    inter = shearwarp_intermediate_fused(
        vol, jr.tf_table, light, plan, jr.windowing.as_vec4(), clip.center,
        clip.direction, compute_dtype=jnp.float32,
        jitter=JR.jitter_values(plan.n2, plan.n1, frame),
        depth_lam=None if scene_depth is None else JSW.depth_to_lambda_max(
            plan, jnp.asarray(scene_depth), W, H),
        mode={"lit": "lit", "intensity": "intensity", "octree": "unlit"}[mode],
        sample_nearest=mode == "octree", out_layout="chw",
    )
    return np.asarray(warp_to_screen_fused(inter, plan, W, H,
                                           channel_major=True))


CLIP = JS.ClipPlane.create([0.0, -0.05, 0.0], [0.3, 0.8, 0.52])  # world


@pytest.mark.parametrize("mode,mip", [("intensity", 0), ("octree", 0),
                                      ("octree", 1)])
def test_mode_frames_match_jax_fused_path(mode, mip):
    """Intensity and octree frames (jitter on, a clip plane): the port's
    shear-warp frame is the JAX accelerator path's; the second frame takes
    the next jitter. The 24^3 volume pads to 32^3, so an octree frame
    composites the padded mip cut to the data's depth."""
    jr = _jax_renderer(render_mode=mode, octree_mip=mip)
    jr.set_clip_plane(CLIP)
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, pcam = _port_renderer(jr, jcam, jitter=True, render_mode=mode,
                                octree_mip=mip)
    got = port.render(pcam, W, H).numpy()
    got2 = port.render(pcam, W, H).numpy()
    want = _jax_frame(jr, jcam, mode, mip)
    assert got.shape == (H, W, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got2, _jax_frame(jr, jcam, mode, mip, frame=1),
                               rtol=0, atol=1e-4)
    assert port._frame_index == 2 and not np.array_equal(got, got2)
    assert port._sw_plan is not None and port._sw_key[:2] == (mode, mip)
    if mode == "octree":
        want_shape = (32 >> mip, 32 >> mip, 24 >> mip)
        assert port._sw_key[-3] == want_shape  # the cut mip's shape
        assert port.octree is not None
    else:
        assert port.octree is None  # intensity builds no pyramid
    assert port._lights_dirty  # neither mode builds the illumination


def test_lit_frame_with_scene_depth_matches_jax():
    """A lit shear-warp frame behind an opaque plane through the volume:
    the λ ceiling of `depth_to_lambda_max` in K1, as the JAX accelerator
    path computes it; the plane removes alpha."""
    jr = _jax_renderer()
    jcam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    depth = np.array(JR.scene_depth_from_plane(
        jcam, jr.transform, W, H, [0.1, 0.0, 0.0], [0.3, 0.9, 0.2]))
    port, pcam = _port_renderer(jr, jcam, jitter=True)
    got = port.render(pcam, W, H, scene_depth=depth).numpy()
    want = _jax_frame(jr, jcam, scene_depth=depth)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    full = port.render(pcam, W, H).numpy()  # the next frame, no depth
    assert port._sw_plan is not None
    assert got[..., 3].sum() < full[..., 3].sum() - 1.0


@pytest.mark.parametrize("mode", ["intensity", "octree"])
def test_mode_march_fallback_matches_jax(mode):
    """The camera inside the volume: no shear-warp plan, the frame marches
    (`march_intensity`, `march_octree`) as the JAX renderer on the CPU
    does, with the march's jitter of frame 0; at the renderer tests'
    march tolerance."""
    jr = _jax_renderer(jitter=True, render_mode=mode, march_impl="scan")
    jr.set_clip_plane(CLIP)
    jcam = JS.Camera.look_at(*INSIDE)
    port, pcam = _port_renderer(jr, jcam, jitter=True, render_mode=mode,
                                march_impl="auto")
    want = np.asarray(jr.render(jcam, W, H))
    got = port.render(pcam, W, H).numpy()
    assert port._frame_index == 1 and port._sw_plan is None
    assert got.shape == (H, W, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=MARCH_RTOL, atol=MARCH_ATOL)


def test_modes_switch_and_scene_depth_on_march_frames():
    """Every mode renders through `set_render_mode`; a march frame clips
    its rays at the scene depth; an unknown mode is refused."""
    vol = synthetic.ct_like_phantom((16, 16, 16))
    r = Renderer(vol, config=RendererConfig(step_count=16), device="cpu")
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    frames = {}
    for mode in ("intensity", "octree", "lit"):
        r.set_render_mode(mode)
        frames[mode] = r.render(cam, 16, 16)
        assert bool(frames[mode].isfinite().all())
        assert float(frames[mode][..., 3].max()) > 0.5
    assert not torch.equal(frames["intensity"], frames["octree"])
    with pytest.raises(ValueError, match="unknown render mode"):
        r.set_render_mode("x-ray")
    inside = PS.Camera.look_at(*INSIDE)
    at_camera = np.zeros((16, 16), np.float32)  # rays of zero length
    img = r.render(inside, 16, 16, scene_depth=at_camera)  # a march frame
    assert r._sw_plan is None and float(img.abs().max()) == 0.0
    assert float(r.render(inside, 16, 16)[..., 3].max()) > 0.5


@pytest.mark.parametrize("march_impl", ["auto", "pallas"])
def test_inside_camera_marches_like_jax(march_impl):
    """The camera inside the volume: "auto" finds no shear-warp plan and
    marches through K9 (its plain version here), as "pallas" always does;
    jitter on, from the march's own field at frame 0."""
    jr = _jax_renderer(jitter=True, march_impl="scan")
    jcam = JS.Camera.look_at(*INSIDE)
    port, pcam = _port_renderer(jr, jcam, jitter=True, march_impl=march_impl)
    want = np.asarray(jr.render(jcam, W, H))
    got = port.render(pcam, W, H).numpy()
    assert port._frame_index == 1 and port._sw_plan is None
    assert (port._sw_key is None) == (march_impl == "pallas")  # no plan made
    assert got.shape == (H, W, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=MARCH_RTOL, atol=MARCH_ATOL)


def test_shearwarp_fallback_mid_orbit_and_recovery():
    """``march_impl="shearwarp"`` marches the frame whose camera enters the
    dominant slab and takes shear-warp again when it leaves (the JAX
    package's `tests/test_renderer.py::test_shearwarp_fallback_mid_orbit`);
    the march frame matches the JAX renderer's fallback."""
    jr = _jax_renderer()
    outside = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    port, _ = _port_renderer(jr, JS.Camera.look_at(*CAM, fov_degrees=40.0))
    img = port.render(outside, W, H)
    assert port._sw_plan is not None and bool(img.isfinite().all())
    img2 = port.render(PS.Camera.look_at(*INSIDE), W, H).numpy()
    assert port._sw_plan is None and np.isfinite(img2).all()
    want = np.asarray(jr.render(JS.Camera.look_at(*INSIDE), W, H))
    np.testing.assert_allclose(img2, want, rtol=MARCH_RTOL, atol=MARCH_ATOL)
    img3 = port.render(outside, W, H)
    assert port._sw_plan is not None  # the fast path is back
    assert torch.equal(img3, img)


@pytest.mark.parametrize("ess", [True, False])
def test_blocked_march_matches_jax(ess):
    """``march_impl="blocked"``: the tiled blocked march (32x32 tiles) with
    empty-space skipping on the occupancy grid, or the blocked march
    without; the same operations in the same order as the JAX renderer's,
    so atol 2e-5."""
    jr = _jax_renderer(jitter=True, march_impl="blocked",
                       empty_space_skipping=ess)
    jcam = JS.Camera.look_at(*INSIDE)
    port, pcam = _port_renderer(jr, jcam, jitter=True, march_impl="blocked",
                                empty_space_skipping=ess)
    for frame in range(2):  # the port's grid comes on the second frame
        assert port._occ is None
        want = np.asarray(jr.render(jcam, W, H))
        got = port.render(pcam, W, H).numpy()
        assert want[..., 3].max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (port._occ is not None) == ess
    port.set_window_width(0.7)  # the grid depends on the window
    assert port._occ is None
