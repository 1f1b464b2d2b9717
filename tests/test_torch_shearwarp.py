"""PyTorch port vs the JAX package: shear-warp plan, pre-shear, plain warp."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW

DIMS = (24, 24, 24)
W, H = 64, 48


def _cams(pos, target=(0.0, 0.0, 0.0), fov=40.0, up=(0.0, 0.0, 1.0)):
    return (JS.Camera.look_at(pos, target, up=up, fov_degrees=fov),
            PS.Camera.look_at(pos, target, up=up, fov_degrees=fov))


def _rolled():
    """A camera rolled 90 degrees: the warp swaps screen u and v."""
    jc, pc = _cams((0.1, -2.3, 0.4))
    rot = np.asarray(jc.rotation)
    rolled = np.stack([rot[1], -rot[0], rot[2]])
    return (dataclasses.replace(jc, rotation=jnp.asarray(rolled, jnp.float32)),
            PS.Camera(pc.position, rolled, pc.tan_half_fov))


def _axis_aligned(axis, sign):
    pos = [0.5004, 0.4997, 0.5003]
    pos[axis] = 0.5 + sign * 2.5
    return _cams(pos, (0.5, 0.5, 0.5), fov=30.0)


CASES = {
    "bench": lambda: _cams((0.1, -2.3, 0.4)),
    "side": lambda: _cams((2.1, 0.7, 0.9)),
    "top": lambda: _cams((-0.4, 0.9, 2.4)),
    "rolled_up": lambda: _cams((0.3, -2.1, 0.6), up=(0.35, 0.2, 0.91)),
    "swap_warp": _rolled,
    "axis0+": lambda: _axis_aligned(0, 1),
    "axis1-": lambda: _axis_aligned(1, -1),
    "axis2+": lambda: _axis_aligned(2, 1),
}


def _plans(case, vol_dims=DIMS, light_dims=DIMS, width=W, height=H, **kw):
    jc, pc = CASES[case]()
    jt, pt = JS.VolumeTransform.create(), PS.VolumeTransform.create()
    return (JSW.plan_shearwarp(jc, jt, vol_dims, light_dims, width, height, **kw),
            PSW.plan_shearwarp(pc, pt, vol_dims, light_dims, width, height, **kw))


def _assert_plans_equal(jp, pp):
    for f in dataclasses.fields(pp):
        if f.name == "j0":  # a column slab's offset; a JAX plan is whole
            assert pp.j0 == 0
            continue
        a, b = getattr(pp, f.name), getattr(jp, f.name)
        if b is None:
            assert a is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kw", [dict(max_n=64), dict(max_planes=20),
                                dict(max_n=128, max_planes=None)])
def test_plan_matches_jax_exactly(case, kw):
    jp, pp = _plans(case, **kw)
    assert jp is not None and pp is not None
    _assert_plans_equal(jp, pp)
    if case == "swap_warp":
        assert pp.swap_warp


def test_plan_anisotropic_half_res_light_and_inside_slab():
    jp, pp = _plans("bench", vol_dims=(24, 20, 28), light_dims=(12, 10, 14),
                    width=93, height=61, max_planes=17)
    _assert_plans_equal(jp, pp)
    inside = ((0.3, 0.45, 0.35), (0.31, 0.5, 0.37))
    jc = JS.Camera.look_at(*inside, fov_degrees=60.0)
    pc = PS.Camera.look_at(*inside, fov_degrees=60.0)
    assert JSW.plan_shearwarp(jc, JS.VolumeTransform.create(), DIMS, DIMS,
                              W, H) is None
    assert PSW.plan_shearwarp(pc, PS.VolumeTransform.create(), DIMS, DIMS,
                              W, H) is None


@pytest.mark.parametrize("max_planes", [None, 20])
def test_resample_block_matches_jax(rng, max_planes):
    jp, pp = _plans("side", max_n=128, max_planes=max_planes)
    vol = rng.random(DIMS, dtype=np.float32)
    ax = (pp.axis,) + pp.axes12
    jv = JSW._volume_planes(jnp.transpose(jnp.asarray(vol), ax), jp)
    want = np.asarray(JSW._resample_block(
        jv, jp.a1, jp.b1, jp.a2, jp.b2, jp.n1, jp.n2, jnp.float32))
    pv = PSW._volume_planes(torch.from_numpy(vol).permute(ax), pp)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    got = PSW._resample_block(pv, t(pp.a1), t(pp.b1), t(pp.a2), t(pp.b2),
                              pp.n1, pp.n2)
    assert tuple(got.shape) == (pp.k, pp.n1, pp.n2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def smooth_image(rng, n1, n2, c=4):
    """A smooth (n1, n2, c) image in [0, 1], as a composite produces.

    The warp's index fields come out of float32 arithmetic that XLA's CPU
    backend contracts into fused multiply-adds, so the two packages'
    indices can differ by an ulp (1.5e-5 texel at index 128); the image
    difference is that times the image's slope per texel. A smooth image
    keeps the comparison about the geometry; exact index-given lerps are
    checked with random rows in `test_lerp_take_matches_jax`.
    """
    i = np.arange(n1)[:, None, None] / n1
    j = np.arange(n2)[None, :, None] / n2
    ph = rng.random((2, c)) * 6.28
    img = 0.5 + 0.25 * np.sin(6.28 * 2 * i + ph[0]) + 0.25 * np.cos(
        6.28 * 3 * j + ph[1])
    return img.astype(np.float32)


@pytest.mark.parametrize("case", ["bench", "swap_warp", "axis2+"])
def test_plain_warp_matches_jax(rng, case):
    jp, pp = _plans(case, max_n=64)
    inter = smooth_image(rng, pp.n1, pp.n2)
    want = np.asarray(JSW.warp_to_screen(jnp.asarray(inter), jp, W, H))
    got = PSW.warp_to_screen(torch.from_numpy(inter), pp, W, H).numpy()
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.max() > 0.05


def test_lerp_take_matches_jax(rng):
    rows = rng.random((20, 300), dtype=np.float32)
    idx = (np.linspace(-5, 310, 260)[None, :]
           + rng.random((20, 260)) * 3.0).astype(np.float32)
    want = np.asarray(JSW._lerp_take(jnp.asarray(rows), jnp.asarray(idx)))
    got = PSW._lerp_take(torch.from_numpy(rows), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
