"""The port's inverse-rendering loop, `models/fitting.py::fit`, against the
JAX package's on the CPU: five Adam steps from the same leaves
(`convert.to_port_render_params`) through the blocked march and through
the dense shear-warp composite, the losses, the per-leaf gradient norms and
the metrics' keys; and the window-center recovery of
`tests/test_grads.py::test_fit_recovers_window_center` at its size.

Tolerances: the first step's loss at rtol 1e-5 and its gradient norms at
rtol 1e-4 (`MARCH_GRAD_RTOL`: the same leaves, the gradients summed in
other orders); the later steps' losses at rtol 1e-3. Adam divides each gradient
component by its own running scale, so a component whose gradient is
rounding noise on both sides (TF texels no sample reaches) steps by about
the learning rate in either direction, and the trajectories part by a few
1e-4 of the loss over five steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.models import fitting as JF
from tbraymarcherplugin_tpu.models import pipeline as JP
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import synthetic as JSyn
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch import convert
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.models import fitting as PF
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW

DIMS = (12, 12, 12)
LIGHTS = ((0.3, 0.1, -0.95),)
CAM = ((0.2, -2.4, 0.4), (0.0, 0.0, 0.0))
FIELDS = PF.FIELDS
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-3
GRAD_NORM_RTOL = 1e-4


def _scene(img, center=0.45):
    """`tests/test_grads.py`'s scene: a sphere and a smooth TF."""
    tf = JT.tf_from_keypoints(
        [0, 0.5, 1.0],
        [[0.1, 0.2, 0.8, 0.0], [0.9, 0.4, 0.2, 0.5], [1.0, 1.0, 0.9, 1.0]])
    params = dict(volume=np.asarray(JSyn.sphere_volume(DIMS, radius=0.35)),
                  tf_table=np.asarray(tf), window_center=np.float32(center),
                  window_width=np.float32(0.9),
                  light_intensities=np.asarray([1.0], np.float32))
    jcam = JS.Camera.look_at(*CAM, fov_degrees=32.0)
    pcam = PS.Camera.look_at(*CAM, fov_degrees=32.0)
    jt, pt = JS.VolumeTransform.create(), PS.VolumeTransform.create()
    return params, (jcam, jt), (pcam, pt)


def _jax_params(arrays):
    return JP.RenderParams(**{f: jnp.asarray(arrays[f]) for f in FIELDS})


@pytest.mark.parametrize("march_impl", ["blocked", "shearwarp"])
def test_fit_matches_jax(march_impl):
    img = 10
    arrays, (jcam, jt), (pcam, pt) = _scene(img)
    plan_kw = dict(max_n=64)
    jplan = (JSW.plan_shearwarp(jcam, jt, DIMS, DIMS, img, img, **plan_kw)
             if march_impl == "shearwarp" else None)
    pplan = (PSW.plan_shearwarp(pcam, pt, DIMS, DIMS, img, img, **plan_kw)
             if march_impl == "shearwarp" else None)
    jrays = JR.setup_rays(jcam, jt, img, img)
    prays = PR.setup_rays(pcam, pt, img, img)
    jplans = tuple(JP.LightPlan.create(d, DIMS) for d in LIGHTS)
    jclip, pclip = JS.ClipPlane.disabled(), PS.ClipPlane.disabled()
    target = np.asarray(JP.render_lit_scene(
        _jax_params(arrays), jrays, jclip.center, jclip.direction, jplans,
        DIMS, step_count=20, march_impl=march_impl, shearwarp_plan=jplan))
    assert target[..., 3].max() > 0.1
    start = dict(arrays, window_center=np.float32(0.6))
    kw = dict(steps=5, step_count=20, learning_rate=2e-2,
              march_impl=march_impl)

    _, want, want_m = JF.fit(
        _jax_params(start), jrays, jnp.asarray(target), jclip.center,
        jclip.direction, jplans, DIMS,
        JF.FitConfig(shearwarp_plan=jplan, **kw), return_metrics=True)
    params, plans = convert.to_port_render_params(start, LIGHTS, DIMS)
    fitted, got, got_m = PF.fit(
        params, prays, torch.from_numpy(target.copy()), pclip.center,
        pclip.direction, plans, DIMS,
        PF.FitConfig(shearwarp_plan=pplan, **kw), return_metrics=True)
    assert float(params.window_center) == np.float32(0.6)  # not trained
    assert len(got) == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, want, rtol=LATER_RTOL)
    assert [sorted(m) for m in got_m] == [sorted(m) for m in want_m]
    for f in FIELDS:  # the first step: the same leaves on both sides
        k = "grad_norm/" + f
        assert want_m[0][k] > 0, k
        np.testing.assert_allclose(got_m[0][k], want_m[0][k],
                                   rtol=GRAD_NORM_RTOL, err_msg=k)
    assert all(m["ms_per_step"] > 0 and m["rays_per_s"] > 0 for m in got_m)
    # the masked leaves stay, the TF stays in [0, 1], the window moved
    assert torch.equal(fitted.volume, params.volume)
    assert float(fitted.tf_table.min()) >= 0 and float(
        fitted.tf_table.max()) <= 1
    assert float(fitted.window_center) != np.float32(0.6)


def test_fit_recovers_window_center():
    """Render a target at one window center, start from another, fit it
    back (`tests/test_grads.py`: 10x10 rays, 20 steps, 100 Adam steps)."""
    from tbraymarcherplugin_tpu_torch.models.pipeline import render_lit_scene

    arrays, _, (pcam, pt) = _scene(10)
    params, plans = convert.to_port_render_params(arrays, LIGHTS, DIMS)
    rays = PR.setup_rays(pcam, pt, 10, 10)
    clip = PS.ClipPlane.disabled()
    with torch.no_grad():
        target = render_lit_scene(params, rays, clip.center, clip.direction,
                                  plans, DIMS, step_count=20)
    start = dataclasses.replace(params, window_center=torch.tensor(0.6))
    cfg = PF.FitConfig(learning_rate=2e-2, steps=100, optimize_tf=False,
                       optimize_window=True, step_count=20,
                       tf_smoothness_weight=0.0)
    fitted, losses = PF.fit(start, rays, target, clip.center, clip.direction,
                            plans, DIMS, cfg)
    assert losses[-1] < losses[0] * 0.5
    assert abs(float(fitted.window_center) - 0.45) < abs(0.6 - 0.45)


def test_param_mask_and_losses():
    cfg = PF.FitConfig(optimize_tf=False, optimize_lights=True)
    mask = PF._param_mask(cfg)
    assert (mask.volume, mask.tf_table, mask.window_center,
            mask.window_width, mask.light_intensities) == (0.0, 0.0, 1.0,
                                                           1.0, 1.0)
    a = torch.tensor([[0.0, 1.0], [1.0, 3.0]])
    assert float(PF.image_loss(a, torch.zeros_like(a))) == 11.0 / 4
    assert float(PF.tf_smoothness(a)) == (1.0 + 4.0) / 2
