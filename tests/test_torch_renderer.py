"""The slice as a whole: the port's `Renderer` on the CPU (every kernel's
plain version) vs the JAX package's `Renderer`, from the same state carried
across by `convert.to_port_state`: shear-warp frames, and march frames for
a camera inside the volume."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu import renderer as JRm
from tbraymarcherplugin_tpu import scene as JS
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
    st = to_port_state(arrays)
    cfg.setdefault("march_impl", "shearwarp")
    r = Renderer(st["volume"], tf_table=st["tf_table"],
                 windowing=st["windowing"], transform=st["transform"],
                 clip_plane=st["clip_plane"],
                 config=RendererConfig(step_count=STEPS, jitter=jitter,
                                       **cfg))
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


def test_unported_paths_raise_not_implemented():
    vol = synthetic.ct_like_phantom((16, 16, 16))
    with pytest.raises(NotImplementedError, match="later slice"):
        Renderer(vol, config=RendererConfig(render_mode="intensity"))
    with pytest.raises(NotImplementedError, match="later slice"):
        Renderer(vol, config=RendererConfig(render_mode="octree"))
    r = Renderer(vol, config=RendererConfig(step_count=16))
    with pytest.raises(NotImplementedError, match="later slice"):
        r.set_render_mode("octree")
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    depth = np.ones((16, 16), np.float32)
    with pytest.raises(NotImplementedError, match="scene-depth"):
        r.render(cam, 16, 16, scene_depth=depth)  # a shear-warp frame
    inside = PS.Camera.look_at(*INSIDE)
    img = r.render(inside, 16, 16, scene_depth=depth)  # a march frame
    assert r._sw_plan is None and bool(img.isfinite().all())


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
    want = np.asarray(jr.render(jcam, W, H))
    got = port.render(pcam, W, H).numpy()
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (port._occ is not None) == ess
    port.set_window_width(0.7)  # the grid depends on the window
    assert port._occ is None
