"""K12, the pre-shear (`ops/preshear.py`, `csrc/preshear.cu`).

On the CPU: the plain version against the JAX package's pre-shear
(`_resample_block` of `_volume_planes`, and of the light planes' lerp)
on each principal axis, at exact and lerped plane positions, with the
jitter's padding plane, the nearest texel, a column slab and a light
volume of other dimensions than the volume; the autograd Function's
gradients for both sources against autograd through the tent matrices'
`bmm` composition in float64; the chunk occupancy from the volume's
per-slice ranges, which flags every chunk the planes' own ranges flag.

On the card (`-m cuda`, skipped without one): K12 against the plain
version at the chest CT's shapes, the adjoint against the plain adjoint
at the fit's, the same bits on two runs, one launch a stream and frame,
no upload inside the pre-shear's span on a cached plan's frame, and no
`bmm` or `_resample_block` on the card's path.

This file imports JAX only inside its CPU tests; on the machine with the
card run it as

    python -m pytest tests/test_torch_preshear.py -q --noconftest -m cuda
"""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import composite as PC
from tbraymarcherplugin_tpu_torch.ops import preshear as PP
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import transfer as T

DIMS = (24, 20, 16)
LIGHT_DIMS = (13, 10, 9)  # another grid than the volume's (a half-res light)
# cameras whose principal axis is Y, X and Z, in that order
CAMS = ((0.1, -2.3, 0.4), (2.1, 0.7, 0.9), (-0.4, 0.9, 2.4))
WIN = [0.45, 0.7, 1.0, 1.0]
HERE = os.path.dirname(os.path.abspath(__file__))


def _plan(cam_pos, max_planes, dims=DIMS, light_dims=DIMS, jax=False):
    mod = PSW
    scene = PS
    if jax:
        from tbraymarcherplugin_tpu import scene as scene
        from tbraymarcherplugin_tpu.ops import shearwarp as mod
    return mod.plan_shearwarp(
        scene.Camera.look_at(list(cam_pos), [0.0, 0.0, 0.0],
                             fov_degrees=40.0),
        scene.VolumeTransform.create(), dims, light_dims, 64, 48, max_n=64,
        max_planes=max_planes)


def _kbuf(plan, jitter=True):
    return -(-plan.k // PC.KB) * PC.KB + (1 if jitter else 0)


def _light(dims=LIGHT_DIMS):
    return np.random.default_rng(5).random(dims, dtype=np.float32)


def _jax_planes(jp, vol, light, kbuf, nearest=False):
    """The JAX package's volume and light planes, edge-padded to kbuf."""
    import jax.numpy as jnp
    from tbraymarcherplugin_tpu.ops import shearwarp as JSW

    ax = (jp.axis,) + tuple(jp.axes12)

    def pad(x):
        return jnp.concatenate([x, jnp.repeat(x[-1:], kbuf - x.shape[0], 0)])

    vp = JSW._volume_planes(jnp.transpose(jnp.asarray(vol), ax), jp,
                            nearest=nearest)
    W = JSW._resample_block(pad(vp), *(pad(jnp.asarray(getattr(jp, n)))
                                       for n in ("a1", "b1", "a2", "b2")),
                            jp.n1, jp.n2, jnp.float32, nearest=nearest)
    lt = jnp.transpose(jnp.asarray(light), ax)
    lm0 = jnp.asarray(jp.lm0)
    lmt = jnp.asarray(jp.lmt)[:, None, None]
    lp = (lt[lm0] * (1.0 - lmt)
          + lt[jnp.minimum(lm0 + 1, lt.shape[0] - 1)] * lmt)
    L = JSW._resample_block(pad(lp), *(pad(jnp.asarray(getattr(jp, n)))
                                       for n in ("la1", "lb1", "la2", "lb2")),
                            jp.n1, jp.n2, jnp.float32)
    return np.asarray(W), np.asarray(L)


@pytest.mark.parametrize("max_planes", [None, 13])
@pytest.mark.parametrize("cam_pos", CAMS)
def test_plain_matches_jax_preshear(cam_pos, max_planes):
    """Both streams on each principal axis, exact (one plane a slice) and
    lerped plane positions, the jitter's padding plane, a light volume of
    other dimensions: within 1e-5 of the JAX package's float32 planes."""
    pp = _plan(cam_pos, max_planes, light_dims=LIGHT_DIMS)
    jp = _plan(cam_pos, max_planes, light_dims=LIGHT_DIMS, jax=True)
    assert (pp.mfrac is None) == (max_planes is None)
    vol = synthetic.ct_like_phantom(DIMS, seed=1)
    light = _light()
    kbuf = _kbuf(pp)
    vs, ls = PP.plan_streams(pp, kbuf, DIMS, LIGHT_DIMS, False, "cpu")
    W = PP.preshear(torch.from_numpy(vol), vs, torch.float32)
    L = PP.preshear(torch.from_numpy(light), ls, torch.float32)
    wantW, wantL = _jax_planes(jp, vol, light, kbuf)
    assert W.shape == (kbuf, pp.n1, pp.n2) == L.shape
    assert np.abs(wantW).max() > 0.1 and np.abs(wantL).max() > 0.1
    np.testing.assert_allclose(W.numpy(), wantW, rtol=0, atol=1e-5)
    np.testing.assert_allclose(L.numpy(), wantL, rtol=0, atol=1e-5)
    # the padding planes repeat the last plane
    assert torch.equal(W[pp.k:], W[pp.k - 1:pp.k].expand_as(W[pp.k:]))


@pytest.mark.parametrize("max_planes", [None, 13])
@pytest.mark.parametrize("cam_pos", CAMS)
def test_plain_nearest_is_jax_nearest(cam_pos, max_planes):
    """The octree mode's nearest texel of the nearest slice: the JAX
    package's one-hot selection, bit for bit."""
    pp = _plan(cam_pos, max_planes)
    jp = _plan(cam_pos, max_planes, jax=True)
    vol = synthetic.ct_like_phantom(DIMS, seed=2)
    kbuf = _kbuf(pp, jitter=False)
    vs, _ = PP.plan_streams(pp, kbuf, DIMS, None, True, "cpu")
    assert vs.nearest and not vs.lerp
    got = PP.preshear(torch.from_numpy(vol), vs, torch.float32).numpy()
    want, _ = _jax_planes(jp, vol, _light(DIMS), kbuf, nearest=True)
    np.testing.assert_array_equal(got, want)
    assert np.isin(got[0], vol).all()


@pytest.mark.parametrize("cam_pos", CAMS)
def test_column_slab_is_the_grid_columns(cam_pos):
    """A column slab (``plan.j0``) samples the whole grid's columns j0 ..
    j0 + n2 - 1, bit for bit, in both streams."""
    pp = _plan(cam_pos, 13)
    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=3))
    light = torch.from_numpy(_light(DIMS))
    kbuf = _kbuf(pp)
    whole = PP.plan_streams(pp, kbuf, DIMS, DIMS, False, "cpu")
    j0, nb = pp.n2 // 4, pp.n2 // 2
    slab = dataclasses.replace(pp, j0=j0, n2=nb)
    part = PP.plan_streams(slab, kbuf, DIMS, DIMS, False, "cpu")
    for src, a, b in ((vol, whole[0], part[0]), (light, whole[1], part[1])):
        full = PP.preshear(src, a, torch.float32)
        assert torch.equal(PP.preshear(src, b, torch.float32),
                           full[:, :, j0:j0 + nb])


def _bmm_planes(src, plan, kbuf, light):
    """Today's composition in float64: the slices' lerp, edge padding and
    the tent matrices' two bmm."""
    ax = (plan.axis,) + tuple(plan.axes12)
    s = src.permute(ax)
    names = ("la1", "lb1", "la2", "lb2") if light else ("a1", "b1", "a2",
                                                         "b2")

    def coeff(n):
        return PSW._pad_to(PSW._t(getattr(plan, n), "cpu").double(), kbuf)

    if light:
        lm0 = PSW._t(plan.lm0, "cpu")
        lmt = PSW._t(plan.lmt, "cpu").double()[:, None, None]
        planes = (s[lm0] * (1.0 - lmt)
                  + s[(lm0 + 1).clamp(max=s.shape[0] - 1)] * lmt)
    else:
        planes = PSW._volume_planes(s, plan)
    return PSW._resample_block(PSW._pad_to(planes, kbuf),
                               *(coeff(n) for n in names), plan.n1, plan.n2,
                               torch.float64, j0=plan.j0)


@pytest.mark.parametrize("max_planes", [None, 13])
@pytest.mark.parametrize("cam_pos", CAMS)
def test_function_gradients_match_bmm_autograd(cam_pos, max_planes):
    """The Function's gradient to the volume and to a light volume of
    other dimensions (the plain adjoint on the CPU) against autograd
    through the bmm composition in float64."""
    pp = _plan(cam_pos, max_planes, light_dims=LIGHT_DIMS)
    kbuf = _kbuf(pp)
    vs, ls = PP.plan_streams(pp, kbuf, DIMS, LIGHT_DIMS, False, "cpu")
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (kbuf, pp.n1, pp.n2)))
    for src, st, light in (
            (synthetic.ct_like_phantom(DIMS, seed=4), vs, False),
            (_light(), ls, True)):
        x64 = torch.from_numpy(src).double().requires_grad_()
        (_bmm_planes(x64, pp, kbuf, light) * g).sum().backward()
        x = torch.from_numpy(src).requires_grad_()
        (PP.preshear(x, st, torch.float32) * g.float()).sum().backward()
        assert x.grad.shape == x.shape and x.grad.dtype == torch.float32
        want = x64.grad.numpy()
        assert np.abs(want).max() > 1.0
        err = np.abs(x.grad.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (light, err)


def _old_occupancy(vol, tf, plan, win, jitter):
    """The chunk flags from the planes' own value ranges (the parent's
    prepare_composite: the lerped planes' min and max)."""
    ax = (plan.axis,) + tuple(plan.axes12)
    vp = PSW._volume_planes(vol.permute(ax), plan)
    c = PS.ClipPlane.disabled()
    ops = PC.composite_args(plan, torch.zeros(1), None, tf, win,
                            (vp.amin((1, 2)), vp.amax((1, 2))), c.center,
                            c.direction, jitter=jitter)
    return ops["occ"]


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("cam_pos", CAMS)
def test_occupancy_keeps_every_flagged_chunk(cam_pos, jitter):
    """The per-slice ranges flag every chunk the planes' ranges flag (and
    the windows leave some chunks empty, so the test has teeth)."""
    pp = _plan(cam_pos, 37)
    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0))
    light = torch.from_numpy(_light(DIMS))
    tf = T.tf_ct_bone()
    jit = torch.full((pp.n1, pp.n2), 0.5) if jitter else None
    empty = 0
    for win in ([0.95, 0.05, 1.0, 1.0], [0.6, 0.1, 1.0, 1.0], WIN):
        w = torch.tensor(win)
        c = PS.ClipPlane.disabled()
        new = PC.prepare_composite(vol, tf, light, pp, w, c.center,
                                   c.direction, jitter=jit)["occ"]
        old = _old_occupancy(vol, tf, pp, w, jit)
        assert new.shape == old.shape
        assert bool((new >= old).all()), (win, old, new)
        empty += int((old == 0).sum())
    assert empty > 0


def test_value_ranges_hold_the_planes():
    """Each plane's values lie in its range from the per-slice ranges."""
    pp = _plan(CAMS[0], 37)
    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=6))
    vs, _ = PP.plan_streams(pp, _kbuf(pp), DIMS, None, False, "cpu")
    planes = PSW._volume_planes(vol.permute(vs.ax), pp)
    mn, mx = PP.plane_value_ranges(PP.slice_ranges(vol, pp.axis), vs, pp.k)
    assert bool((mn <= planes.amin((1, 2))).all())
    assert bool((mx >= planes.amax((1, 2))).all())


def test_renderer_keeps_slice_ranges():
    """The Renderer reduces its volume's slice ranges once for its frames,
    and again for a new volume; the frames are those of ranges reduced
    every frame."""
    from tbraymarcherplugin_tpu_torch.renderer import (Renderer,
                                                       RendererConfig)

    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0))
    cam = PS.Camera.look_at(list(CAMS[0]), [0.0, 0.0, 0.0],
                            fov_degrees=40.0)

    def renderer():
        r = Renderer(vol, tf_table=T.tf_ct_bone(),
                     config=RendererConfig(step_count=20, jitter=False),
                     device="cpu")
        r.add_light("sun", PS.DirLight.create((0.3, 0.1, -0.95), 1.0))
        return r

    r = renderer()
    real = PP.slice_ranges
    with mock.patch.object(PP, "slice_ranges", wraps=real) as spy:
        first = r.render(cam, 64, 48)
        again = r.render(cam, 64, 48)
        assert spy.call_count == 1
        r.set_volume(vol * 0.5)
        r.add_light("sun", PS.DirLight.create((0.3, 0.1, -0.95), 1.0))
        r.render(cam, 64, 48)
        assert spy.call_count == 2
    assert float(first[..., 3].max()) > 0.5
    assert torch.equal(first, again)
    with mock.patch.object(r, "_slice_range",
                           lambda v, axis: real(v, axis)):
        assert torch.equal(renderer().render(cam, 64, 48), first)


def test_streams_are_kept_per_plan():
    """A plan's streams are built and uploaded once, kept with the plan;
    another plan, a column slab of it, another plane count or the nearest
    mode make their own."""
    pp = _plan(CAMS[1], 13)
    kbuf = _kbuf(pp)
    a = PP.plan_streams(pp, kbuf, DIMS, DIMS, False, "cpu")
    assert PP.plan_streams(pp, kbuf, DIMS, DIMS, False, "cpu") is a
    assert PP.plan_streams(pp, kbuf - 1, DIMS, DIMS, False, "cpu") is not a
    assert PP.plan_streams(pp, kbuf, DIMS, DIMS, True, "cpu") is not a
    other = _plan(CAMS[0], 13)
    assert PP.plan_streams(other, _kbuf(other), DIMS, DIMS, False,
                           "cpu") is not a
    slab = dataclasses.replace(pp, j0=8, n2=pp.n2 - 8)
    assert PP.plan_streams(slab, kbuf, DIMS, DIMS, False, "cpu") is not a
    assert PP.plan_streams(pp, kbuf, DIMS, DIMS, False, "cpu") is a
    vs, ls = a
    assert vs.lerp and ls.lerp
    # every plane's slices are within their stream's slice ranges
    for st in a:
        sl = st.slices.numpy()
        for k, (m0, m1) in enumerate(zip(st.m0.tolist(), st.m1.tolist())):
            for m in (m0, m1):
                assert sl[m, 0] <= k < sl[m, 1]


# --- on the card --------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chest_plan():
    """The chest clip drag cell's plan: 512x512x384 at its spacing and
    camera, 1920x1080, 150 planes."""
    from rmbench import generator

    with open(os.path.join(HERE, "..", "rmbench", "configs",
                           "luna16_chest.json")) as f:
        cfg = json.load(f)
    pos, target, fov = generator.base_camera(cfg)
    scale = tuple(float(x) for x in generator.world_scale(cfg))
    dims = tuple(cfg["dims"])
    plan = PSW.plan_shearwarp(
        PS.Camera.look_at(pos, target, fov_degrees=fov),
        PS.VolumeTransform.create(scale=scale), dims, dims, 1920, 1080,
        max_planes=150)
    return plan, dims


def _bench_plan(dims=(256, 256, 256)):
    return PSW.plan_shearwarp(
        PS.Camera.look_at((0.1, -2.3, 0.4), (0.0, 0.0, 0.0),
                          fov_degrees=40.0),
        PS.VolumeTransform.create(), dims, dims, 1920, 1080, max_planes=150)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_at_chest_shapes(cuda, dtype):
    """Both streams of the chest CT's frame: float32 within a few ulps
    of the plain version, bfloat16 within one rounding of its float32
    value; and the same bits on two launches."""
    dtype = getattr(torch, dtype)
    plan, dims = _chest_plan()
    gen = torch.Generator(cuda).manual_seed(0)
    vol = torch.rand(dims, generator=gen, device=cuda)
    light = torch.rand(dims, generator=gen, device=cuda)
    kbuf = _kbuf(plan)
    vs, ls = PP.plan_streams(plan, kbuf, dims, dims, False, cuda)
    for src, st in ((vol, vs), (light, ls)):
        got = PP.preshear(src, st, dtype)
        again = PP.preshear(src, st, dtype)
        want = PP.preshear_plain(src, st, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 4 * 2.0 ** -24 * float(
                want.abs().max())
        else:  # half a bfloat16 ulp of each value
            assert bool((err <= want.abs() * 2.0 ** -8 + 1e-30).all())
        del got, again, want


@pytest.mark.cuda
@pytest.mark.parametrize("nearest", [False, True])
def test_kernel_modes_match_plain(cuda, nearest):
    """The nearest texel, exact planes, a column slab and a light volume of
    other dimensions (a half-res light), float32, against the plain
    version; a principal axis along Z (strided columns)."""
    dims, ldims = (96, 80, 64), (48, 40, 32)
    gen = torch.Generator(cuda).manual_seed(1)
    vol = torch.rand(dims, generator=gen, device=cuda)
    light = torch.rand(ldims, generator=gen, device=cuda)
    for cam, mp in (((0.5, -2.3, 0.6), None), ((-0.4, 0.9, 2.4), 40)):
        plan = PSW.plan_shearwarp(
            PS.Camera.look_at(cam, (0.0, 0.0, 0.0), fov_degrees=35.0),
            PS.VolumeTransform.create(), dims, ldims, 320, 200,
            max_planes=mp)
        for p in (plan, dataclasses.replace(plan, j0=plan.n2 // 4,
                                            n2=plan.n2 // 2)):
            vs, ls = PP.plan_streams(p, _kbuf(p), dims, ldims, nearest, cuda)
            for src, st in ((vol, vs), (light, ls)):
                got = PP.preshear(src, st, torch.float32)
                want = PP.preshear_plain(src, st, torch.float32)
                torch.cuda.synchronize()
                assert float((got - want).abs().max()) <= 1e-6, (cam, mp)


@pytest.mark.cuda
def test_adjoint_matches_plain_adjoint(cuda):
    """The adjoint at the fit's shapes (the light volume's float32 planes
    of the bench camera) against the plain adjoint, the same bits on two
    runs, and through the Function one launch each way."""
    dims = (256, 256, 256)
    plan = _bench_plan(dims)
    kbuf = _kbuf(plan, jitter=False)
    _, ls = PP.plan_streams(plan, kbuf, dims, dims, False, cuda)
    gen = torch.Generator(cuda).manual_seed(2)
    g = torch.randn((kbuf, plan.n1, plan.n2), generator=gen, device=cuda)
    got = PP.preshear_adjoint(g, ls, dims)
    again = PP.preshear_adjoint(g, ls, dims)
    want = PP.preshear_adjoint_plain(g, ls).permute(
        PP._inverse(ls.ax))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    assert scale > 1.0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    light = torch.rand(dims, generator=gen, device=cuda).requires_grad_()
    before = (PP.preshear.launches, PP.preshear_adjoint.launches)
    (PP.preshear(light, ls, torch.float32) * g).sum().backward()
    assert (PP.preshear.launches, PP.preshear_adjoint.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(light.grad, got)


def _renderer(cuda, dims=(64, 64, 64)):
    from tbraymarcherplugin_tpu_torch.renderer import (Renderer,
                                                       RendererConfig)

    vol = torch.from_numpy(synthetic.ct_like_phantom(dims, seed=0)).to(cuda)
    r = Renderer(vol, tf_table=T.tf_ct_bone(device=cuda),
                 config=RendererConfig(step_count=40, jitter=True),
                 device=cuda)
    r.add_light("sun", PS.DirLight.create((0.3, 0.1, -0.95), 1.0))
    return r


@pytest.mark.cuda
def test_frame_launches_once_a_stream_and_uploads_nothing_cached(cuda):
    """A lit frame launches K12 once for the volume and once for the
    light; the second frame of the same camera makes no host-to-device
    copy inside the pre-shear's span."""
    from torch.profiler import ProfilerActivity, profile

    from tbraymarcherplugin_tpu_torch.utils import profiling as P

    r = _renderer(cuda)
    cam = PS.Camera.look_at((0.1, -2.3, 0.4), (0.0, 0.0, 0.0),
                            fov_degrees=40.0)
    r.render(cam, 320, 200)
    before = PP.preshear.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(cam, 320, 200)
        torch.cuda.synchronize()
    assert PP.preshear.launches == before + 2
    events = prof.events()
    shears = [e for e in events if e.name == P.PRESHEAR]
    uploads = [e for e in events if e.name == P.UPLOAD]
    assert len(shears) == 1
    s = shears[0].time_range
    inside = [u for u in uploads
              if s.start <= u.time_range.start <= s.end]
    assert not inside, [u.name for u in inside]


@pytest.mark.cuda
def test_card_path_takes_no_bmm(cuda):
    """prepare_composite on the card in every mode reaches neither
    `_resample_block` nor `bmm`."""
    r = _renderer(cuda)
    r.ensure_lighting()
    plan = _bench_plan((64, 64, 64))
    win = torch.tensor(WIN, device=cuda)
    c = PS.ClipPlane.disabled()
    jit = torch.rand((plan.n1, plan.n2), device=cuda)

    def refuse(*a, **k):
        raise AssertionError("the card's pre-shear reached a bmm")

    with mock.patch.object(PSW, "_resample_block", refuse), \
            mock.patch.object(torch, "bmm", refuse):
        for mode, nearest in (("lit", False), ("unlit", True),
                              ("intensity", False)):
            ops = PC.prepare_composite(
                r.volume, r.tf_table, r.light_volume, plan, win, c.center,
                c.direction, jitter=jit, mode=mode, sample_nearest=nearest)
            assert ops["W"].dtype == torch.bfloat16
            PC.composite(**ops)
    torch.cuda.synchronize()
