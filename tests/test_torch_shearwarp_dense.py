"""The dense differentiable shear-warp composite on the CPU:
`ops/shearwarp.py::shearwarp_intermediate` (both TF units, both
``stop_early`` values) and `shearwarp_lit` against the JAX package's on a
16^3 phantom with a clip plane, and `render_lit_scene`'s dense branches
(``shearwarp_tf_unit`` "xla" and "pallas") against ``jax.grad`` of the JAX
package's, loss and all five leaves.

Tolerances: the composite's RGBA at atol 5e-5 (float32 ulps through the
cumulative product; the pre-shear matmuls sum in another order); the
gradients as |got - want|_2 / |want|_2 per leaf at the march branches'
`MARCH_GRAD_RTOL` (the illumination's backward and the per-block
recompute sum in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.models import pipeline as JP
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import synthetic as JSyn
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import tf_rgba as PK10
from test_torch_grad_pipeline import (
    DIMS as SCENE_DIMS, FIELDS, H, MARCH_GRAD_RTOL, W, _jax_scene,
    _port_scene,
)

DIMS = (16, 16, 16)
CLIP = ([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])
WIN = [0.45, 0.8, 1.0, 1.0]
CAM = ((0.1, -2.3, 0.4), (0.0, 0.0, 0.0))
FWD_ATOL = 5e-5


def _plans(**kw):
    jp = JSW.plan_shearwarp(JS.Camera.look_at(*CAM, fov_degrees=40.0),
                            JS.VolumeTransform.create(), DIMS, DIMS, 48, 32,
                            max_n=64, **kw)
    pp = PSW.plan_shearwarp(PS.Camera.look_at(*CAM, fov_degrees=40.0),
                            PS.VolumeTransform.create(), DIMS, DIMS, 48, 32,
                            max_n=64, **kw)
    return jp, pp


def _inputs(rng):
    vol = JSyn.ct_like_phantom(DIMS, seed=0)
    lv = rng.random(DIMS, dtype=np.float32)
    return vol, np.array(JT.tf_ct_bone()), lv, np.asarray(WIN, np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("tf_unit", ["xla", "pallas"])
def test_shearwarp_intermediate_matches_jax(rng, tf_unit):
    jplan, plan = _plans()
    assert plan.k % 8 == 0  # whole blocks: see the ragged test below
    arrays = _inputs(rng)
    jc, pc = JS.ClipPlane.create(*CLIP), PS.ClipPlane.create(*CLIP)
    g = rng.random((plan.n1, plan.n2, 4), dtype=np.float32)

    def jfn(v, t, lv, w, stop_early=False):
        return JSW.shearwarp_intermediate(
            v, t, lv, jplan, w, jc.center, jc.direction,
            stop_early=stop_early, tf_unit=tf_unit)

    jargs = [jnp.asarray(x) for x in arrays]
    want = np.asarray(jfn(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                          argnums=(0, 1, 2, 3))(*jargs)
    assert want[..., 3].max() > 0.5

    launches = PK10.windowed_tf_rgba.launches
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in arrays]
    got = PSW.shearwarp_intermediate(leaves[0], leaves[1], leaves[2], plan,
                                     leaves[3], pc.center, pc.direction,
                                     tf_unit=tf_unit)
    assert PK10.windowed_tf_rgba.launches == launches  # CPU: plain versions
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_ATOL)
    (got * torch.from_numpy(g)).sum().backward()
    for name, leaf, ref in zip(("volume", "tf", "light", "window"), leaves,
                               want_grads):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        assert _rel(leaf.grad.numpy(), ref) <= MARCH_GRAD_RTOL, name

    # forward only: block skipping and the exit once every ray terminated
    want_se = np.asarray(jfn(*jargs, stop_early=True))
    with torch.no_grad():
        got_se = PSW.shearwarp_intermediate(
            *(torch.from_numpy(np.array(x)) for x in arrays[:3]), plan,
            torch.from_numpy(arrays[3]), pc.center, pc.direction,
            stop_early=True, tf_unit=tf_unit)
    np.testing.assert_allclose(got_se.numpy(), want_se, rtol=0,
                               atol=FWD_ATOL)


def test_shearwarp_intermediate_bf16_planes_match_jax(rng):
    """bfloat16 pre-shear operands with float32 products (the JAX
    package's ``preferred_element_type=float32`` einsums), forward and
    gradients; None means float32 on the CPU, as for the fused path."""
    jplan, plan = _plans()
    arrays = _inputs(rng)
    jc, pc = JS.ClipPlane.create(*CLIP), PS.ClipPlane.create(*CLIP)
    g = rng.random((plan.n1, plan.n2, 4), dtype=np.float32)

    def jfn(v, t, lv, w):
        return JSW.shearwarp_intermediate(v, t, lv, jplan, w, jc.center,
                                          jc.direction,
                                          compute_dtype=jnp.bfloat16)

    jargs = [jnp.asarray(x) for x in arrays]
    want = np.asarray(jfn(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                          argnums=(0, 1, 2, 3))(*jargs)

    def port(dtype, grad=False):
        leaves = [torch.from_numpy(np.array(x)).requires_grad_(grad)
                  for x in arrays]
        out = PSW.shearwarp_intermediate(leaves[0], leaves[1], leaves[2],
                                         plan, leaves[3], pc.center,
                                         pc.direction, compute_dtype=dtype)
        return out, leaves

    got, leaves = port(torch.bfloat16, grad=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_ATOL)
    (got * torch.from_numpy(g)).sum().backward()
    for name, leaf, ref in zip(("volume", "tf", "light", "window"), leaves,
                               want_grads):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        assert _rel(leaf.grad.numpy(), ref) <= MARCH_GRAD_RTOL, name

    f32, _ = port(torch.float32)
    assert np.abs(f32.numpy() - want).max() > FWD_ATOL  # bf16 shows
    assert torch.equal(port(None)[0], f32)
    assert PSW.plane_dtype(None, "cpu") == torch.float32
    assert PSW.plane_dtype(None, "cuda") == torch.bfloat16
    assert PSW.plane_dtype(torch.float32, "cuda") == torch.float32


def test_ragged_last_block_is_block_size_invariant(rng):
    """12 planes in blocks of 8: the JAX package slices the last block's
    per-plane lam without padding (the slice's start clamps back to plane
    4), which moves that block's clip test; the port pads lam like every
    other per-plane array, so it gives the JAX answer of whole blocks (4)
    at any block size."""
    jplan, plan = _plans(max_planes=12)
    assert plan.k == 12 and plan.mfrac is not None
    vol, tf, lv, win = _inputs(rng)
    jc, pc = JS.ClipPlane.create(*CLIP), PS.ClipPlane.create(*CLIP)
    want = np.asarray(JSW.shearwarp_intermediate(
        jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lv), jplan,
        jnp.asarray(win), jc.center, jc.direction, block_size=4))
    for bs in (8, 5, 4):
        got = PSW.shearwarp_intermediate(
            torch.from_numpy(vol), torch.from_numpy(tf), torch.from_numpy(lv),
            plan, torch.from_numpy(win), pc.center, pc.direction,
            block_size=bs)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL,
                                   err_msg=f"block_size {bs}")


def test_shearwarp_lit_matches_jax(rng):
    jplan, plan = _plans()
    vol, tf, lv, win = _inputs(rng)
    jc, pc = JS.ClipPlane.create(*CLIP), PS.ClipPlane.create(*CLIP)
    want = np.asarray(JSW.shearwarp_lit(
        jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lv), jplan,
        jnp.asarray(win), jc.center, jc.direction, 48, 32))
    got = PSW.shearwarp_lit(torch.from_numpy(vol), torch.from_numpy(tf),
                            torch.from_numpy(lv), plan, torch.from_numpy(win),
                            pc.center, pc.direction, 48, 32)
    assert got.shape == (32, 48, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("tf_unit", ["xla", "pallas"])
def test_render_lit_scene_dense_grads_match_jax(rng, tf_unit):
    jparams, jrays, jplan, jplans = _jax_scene()
    jclip = JS.ClipPlane.create(*CLIP)
    g = rng.random((H, W, 4), dtype=np.float32)
    kw = dict(march_impl="shearwarp", shearwarp_tf_unit=tf_unit)

    def loss(p):
        return jnp.sum(JP.render_lit_scene(
            p, jrays, jclip.center, jclip.direction, jplans, SCENE_DIMS,
            shearwarp_plan=jplan, **kw) * g)

    want_loss, want = jax.value_and_grad(loss)(jparams)
    params, rays, plan, plans = _port_scene(jparams)
    clip = PS.ClipPlane.create(*CLIP)
    img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                              plans, SCENE_DIMS, shearwarp_plan=plan, **kw)
    assert img.shape == (H, W, 4) and float(img.detach()[..., 3].max()) > 0.5
    got_loss = (img * torch.from_numpy(g)).sum()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_loss.backward()
    for f in FIELDS:
        ref = np.asarray(getattr(want, f))
        assert np.abs(ref).max() > 0, f
        assert _rel(getattr(params, f).grad.numpy(), ref) <= MARCH_GRAD_RTOL, f
