"""The whole differentiable frame, `models.pipeline.render_lit_scene`
(illumination rebuild, fused composite, screen warp), against the JAX
package's on the CPU (Pallas in interpret mode): the image and the
gradients of all five `RenderParams` leaves, and the forward-only
``shearwarp_stop_early`` path against the JAX fused forward. The scene is
`tests/test_shearwarp_grad.py`'s (24^3, 64x48) with one light, as the
fwd+bwd bench lights it.

Tolerances are the JAX package's gradient tests' (rtol 2e-4, atol 2e-5 of
the largest reference value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.models import pipeline as JP
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import synthetic as JSyn
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch import convert
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from test_torch_grad_units import assert_grad_close

DIMS = (24, 24, 24)
W, H = 64, 48
CAM = ((0.1, -2.3, 0.4), (0.0, 0.0, 0.0))
LIGHTS = ((0.3, 0.1, -0.95),)
FIELDS = ("volume", "tf_table", "window_center", "window_width",
          "light_intensities")


def _jax_scene(center=0.55):
    params = JP.RenderParams(
        volume=jnp.asarray(JSyn.ct_like_phantom(DIMS, seed=0)),
        tf_table=JT.tf_ct_bone(), window_center=jnp.float32(center),
        window_width=jnp.float32(0.8),
        light_intensities=jnp.asarray([0.9], jnp.float32))
    cam = JS.Camera.look_at(*CAM, fov_degrees=40.0)
    tr = JS.VolumeTransform.create()
    plan = JSW.plan_shearwarp(cam, tr, DIMS, DIMS, W, H, max_n=64)
    plans = tuple(JP.LightPlan.create(d, DIMS) for d in LIGHTS)
    return params, JR.setup_rays(cam, tr, W, H), plan, plans


def _port_scene(jparams, requires_grad=True):
    params, plans = convert.to_port_render_params(
        {f: np.asarray(getattr(jparams, f)) for f in FIELDS}, LIGHTS, DIMS,
        device="cpu", requires_grad=requires_grad)
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    tr = PS.VolumeTransform.create()
    plan = PSW.plan_shearwarp(cam, tr, DIMS, DIMS, W, H, max_n=64)
    return params, PR.setup_rays(cam, tr, W, H), plan, plans


def _jax_render(params, rays, plan, plans, clip):
    return JP.render_lit_scene(
        params, rays, clip.center, clip.direction, plans, DIMS,
        march_impl="shearwarp", shearwarp_plan=plan,
        shearwarp_tf_unit="fused", illumination_scan_impl="pallas",
        illumination_tf_impl="pallas_vjp")


def test_render_lit_scene_grads_match_jax(rng):
    jparams, jrays, jplan, jplans = _jax_scene()
    jclip = JS.ClipPlane.disabled()
    g = rng.random((H, W, 4), dtype=np.float32)

    def loss(p):
        return jnp.sum(_jax_render(p, jrays, jplan, jplans, jclip) * g)

    want_loss, want = jax.value_and_grad(loss)(jparams)
    params, rays, plan, plans = _port_scene(jparams)
    clip = PS.ClipPlane.disabled()
    img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, DIMS, march_impl="shearwarp",
                              shearwarp_plan=plan, shearwarp_tf_unit="fused")
    assert img.shape == (H, W, 4)
    got_loss = (img * torch.from_numpy(g)).sum()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_loss.backward()
    for f in FIELDS:
        ref = np.asarray(getattr(want, f))
        assert np.abs(ref).max() > 0, f
        # d TF adds the composite's histogram to the occluder field's, and
        # the two cancel: each part reaches several times the sum's largest
        # entry, so the parts' rounding, within the JAX tolerance of their
        # own scale, shows at up to ~3e-5 of the sum's
        atol = 1e-4 if f == "tf_table" else 2e-5
        assert_grad_close(getattr(params, f).grad, ref, f, atol=atol)


def test_stop_early_matches_jax_fused_forward():
    jparams, jrays, jplan, jplans = _jax_scene(0.5)
    want = np.asarray(_jax_render(jparams, jrays, jplan, jplans,
                                  JS.ClipPlane.disabled()))
    params, rays, plan, plans = _port_scene(jparams, requires_grad=True)
    clip = PS.ClipPlane.disabled()
    got = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, DIMS, march_impl="shearwarp",
                              shearwarp_plan=plan, shearwarp_stop_early=True)
    assert not got.requires_grad  # forward only
    assert float(got[..., 3].max()) > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(grad_allreduce_axis="data")])
def test_unported_branches_raise(kw):
    jparams = _jax_scene()[0]
    params, rays, plan, plans = _port_scene(jparams, requires_grad=False)
    clip = PS.ClipPlane.disabled()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PP.render_lit_scene(params, rays, clip.center, clip.direction, plans,
                            DIMS, shearwarp_plan=plan, **kw)


def test_defaults_match_jax(rng):
    """No implementation argument on either side: the JAX package's
    defaults (the blocked march, and for shear-warp the dense "xla"
    composite on float32 planes) are the port's, so the same call renders
    the same image."""
    jparams, jrays, jplan, jplans = _jax_scene()
    params, rays, plan, plans = _port_scene(jparams, requires_grad=False)
    jclip, clip = JS.ClipPlane.disabled(), PS.ClipPlane.disabled()
    kw = dict(step_count=MARCH_STEPS)
    want = np.asarray(JP.render_lit_scene(
        jparams, jrays, jclip.center, jclip.direction, jplans, DIMS, **kw))
    got = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, DIMS, **kw)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=5e-5)
    # the shear-warp branch with only the plan given: the dense composite
    want = np.asarray(JP.render_lit_scene(
        jparams, jrays, jclip.center, jclip.direction, jplans, DIMS,
        march_impl="shearwarp", shearwarp_plan=jplan))
    got = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, DIMS, march_impl="shearwarp",
                              shearwarp_plan=plan)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


# The march branches' gradients against jax.grad of the JAX package's:
# |got - want|_2 / |want|_2 per leaf. The march is the same operations in
# the same order on both sides, but the illumination's backward (K7, K8
# here; the JAX XLA path there) and the checkpointed recompute sum in
# other orders.
MARCH_GRAD_RTOL = 1e-4
MARCH_STEPS = 24


@pytest.mark.parametrize("march_impl", ["blocked", "scan", "tiled2d"])
def test_march_branch_grads_match_jax(rng, march_impl):
    jparams, jrays, _, jplans = _jax_scene()
    jclip = JS.ClipPlane.create([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])
    g = rng.random((H, W, 4), dtype=np.float32)
    # 16-step blocks and checkpoints: several per ray, a ragged last one
    kw = dict(step_count=MARCH_STEPS, checkpoint_every=16,
              march_impl=march_impl)

    def loss(p):
        return jnp.sum(JP.render_lit_scene(
            p, jrays, jclip.center, jclip.direction, jplans, DIMS, **kw) * g)

    want_loss, want = jax.value_and_grad(loss)(jparams)
    params, rays, _, plans = _port_scene(jparams)
    clip = PS.ClipPlane.create([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])
    img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, DIMS, **kw)
    assert img.shape == (H, W, 4) and float(img.detach()[..., 3].max()) > 0.5
    got_loss = (img * torch.from_numpy(g)).sum()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_loss.backward()
    for f in FIELDS:
        ref = np.asarray(getattr(want, f))
        got = getattr(params, f).grad.numpy()
        assert np.abs(ref).max() > 0, f
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= MARCH_GRAD_RTOL, (f, rel)


def test_pallas_branch_is_forward_only_k9():
    jparams, jrays, _, jplans = _jax_scene()
    params, rays, _, plans = _port_scene(jparams)
    clip = PS.ClipPlane.disabled()
    args = (params, rays, clip.center, clip.direction, plans, DIMS)
    kw = dict(step_count=MARCH_STEPS, march_impl="pallas")
    with pytest.raises(RuntimeError, match="forward-only"):
        PP.render_lit_scene(*args, **kw)
    with torch.no_grad():
        got = PP.render_lit_scene(*args, **kw).numpy()
    want = np.asarray(JP.render_lit_scene(
        jparams, jrays, JS.ClipPlane.disabled().center,
        JS.ClipPlane.disabled().direction, jplans, DIMS, step_count=MARCH_STEPS,
        march_impl="scan"))
    assert want[..., 3].max() > 0.5
    # K9 against march_lit: the JAX fused march's tolerance
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


def test_convert_render_params_matches_jax_light_plans():
    jparams = _jax_scene()[0]
    params, plans = convert.to_port_render_params(
        {f: np.asarray(getattr(jparams, f)) for f in FIELDS}, LIGHTS, DIMS,
        device="cpu")
    jplans = tuple(JP.LightPlan.create(d, DIMS) for d in LIGHTS)
    for pp, jp in zip(plans, jplans):
        for a, b in zip(pp.face_plans, jp.face_plans):
            for x, y in zip(a, b):
                np.testing.assert_allclose(np.asarray(x, np.float64),
                                           np.asarray(y, np.float64),
                                           rtol=1e-12)
    assert not params.volume.requires_grad
    np.testing.assert_array_equal(params.tf_table.numpy(),
                                  np.asarray(jparams.tf_table))
