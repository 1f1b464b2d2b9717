"""K1's unlit and intensity modes, its nearest-texel pre-shear and its
scene-depth ceiling: the port's plain versions vs the JAX package's fused
composite (Pallas, interpret mode) and `shearwarp` helpers on the CPU. The
CUDA kernel is held to the plain version in `test_torch_kernels.py`.

Both sides compute the index fields in float32 but XLA's CPU backend may
fuse their multiply-adds, so a coordinate can differ by an ulp. Two places
turn such an ulp into a whole-pixel difference: the nearest selection
floor(v + 0.5) at an exact half texel, and intensity's first hit at the
cube's edge or the clip plane. The cameras here have none: every test
counts the pixels that differ by more than the tolerance and requires 0.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.shearwarp_pallas import (
    shearwarp_intermediate_fused as jfused,
)
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import composite as PC
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import synthetic

DIMS = (24, 24, 24)
W, H = 64, 48
PLANES = 20  # fractional plane positions: the nearest pre-shear's mfrac
WIN = [0.45, 0.7, 1.0, 1.0]
CLIP = ([0.5, 0.5, 0.5], [0.3, 0.8, 0.52])
CAMS = ((0.1, -2.3, 0.4), (2.1, 0.7, 0.9))
ATOL = 2e-5  # test_torch_composite.py's limit


def _plans(cam_pos, dims=DIMS, max_planes=PLANES):
    args = (list(cam_pos), [0.0, 0.0, 0.0])
    jp = JSW.plan_shearwarp(JS.Camera.look_at(*args, fov_degrees=40.0),
                            JS.VolumeTransform.create(), dims, dims, W, H,
                            max_n=64, max_planes=max_planes)
    pp = PSW.plan_shearwarp(PS.Camera.look_at(*args, fov_degrees=40.0),
                            PS.VolumeTransform.create(), dims, dims, W, H,
                            max_n=64, max_planes=max_planes)
    return jp, pp


def _light(dims=DIMS):
    x, y, _ = np.meshgrid(*[np.linspace(0, 1, d) for d in dims],
                          indexing="ij")
    return (0.2 + 0.8 * (0.5 + 0.5 * np.sin(4 * x) * np.cos(3 * y))
            ).astype(np.float32)


def _flips(got, want, atol=ATOL):
    """Pixels (any channel) farther apart than ``atol``."""
    return int((np.abs(got - want) > atol).any(axis=0).sum())


CASES = {
    "intensity_clip": dict(mode="intensity", clip=CLIP),
    "unlit_nearest": dict(mode="unlit", sample_nearest=True),
    "unlit": dict(mode="unlit"),
    "lit_depth": dict(mode="lit", depth=True),
}


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cam_pos", CAMS)
def test_mode_composite_matches_jax(rng, cam_pos, case, jitter):
    cfg = CASES[case]
    jp, pp = _plans(cam_pos)
    vol = synthetic.ct_like_phantom(DIMS, seed=0)
    lv = _light()
    tf = np.array(JT.tf_ct_bone())
    c = PS.ClipPlane(*cfg["clip"]) if "clip" in cfg else (
        PS.ClipPlane.disabled())
    jit = rng.random((pp.n1, pp.n2), dtype=np.float32) if jitter else None
    lmax = None
    if cfg.get("depth"):  # a ceiling mid-volume on the left half, varying
        lam = np.asarray(pp.lam)
        lmax = np.full((pp.n1, pp.n2), np.inf, np.float32)
        lmax[:, : pp.n2 // 2] = lam[len(lam) // 2] + 0.02 * rng.standard_normal(
            (pp.n1, pp.n2 // 2))
    kw = dict(mode=cfg["mode"],
              sample_nearest=cfg.get("sample_nearest", False))
    want = np.asarray(jfused(
        jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lv), jp,
        jnp.asarray(WIN, jnp.float32), jnp.asarray(c.center),
        jnp.asarray(c.direction), compute_dtype=jnp.float32,
        jitter=None if jit is None else jnp.asarray(jit),
        depth_lam=None if lmax is None else jnp.asarray(lmax),
        out_layout="chw", **kw))
    got = PC.shearwarp_intermediate_fused(
        torch.from_numpy(vol), torch.from_numpy(tf),
        torch.from_numpy(lv) if cfg["mode"] == "lit" else None, pp,
        torch.tensor(WIN), c.center, c.direction,
        jitter=None if jit is None else torch.from_numpy(jit),
        depth_lam=None if lmax is None else torch.from_numpy(lmax), **kw,
    ).numpy()
    assert got.shape == (4, pp.n1, pp.n2)
    assert want[3].max() > 0.5
    if cfg["mode"] == "intensity":
        assert set(np.unique(want[3])) == {0.0, 1.0}
        np.testing.assert_array_equal(want[0], want[1])
    if lmax is not None:  # the ceiling removes alpha on the left half
        full = np.asarray(jfused(
            jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lv), jp,
            jnp.asarray(WIN, jnp.float32), jnp.asarray(c.center),
            jnp.asarray(c.direction), compute_dtype=jnp.float32,
            jitter=None if jit is None else jnp.asarray(jit),
            out_layout="chw"))
        left = slice(0, pp.n2 // 2)
        assert want[3][:, left].sum() < full[3][:, left].sum() - 1.0
    assert _flips(got, want) == 0, f"{_flips(got, want)} pixels flipped"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_unlit_differs_from_lit_and_nearest_from_linear():
    """The light stream and the nearest pre-shear each change the image."""
    _, pp = _plans(CAMS[0])
    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0))
    lv = torch.from_numpy(_light())
    tf = torch.from_numpy(np.array(JT.tf_ct_bone()))
    c = PS.ClipPlane.disabled()
    args = (vol, tf, lv, pp, torch.tensor(WIN), c.center, c.direction)
    lit = PC.shearwarp_intermediate_fused(*args)
    unlit = PC.shearwarp_intermediate_fused(*args, mode="unlit")
    nearest = PC.shearwarp_intermediate_fused(*args, mode="unlit",
                                              sample_nearest=True)
    assert torch.equal(lit[3], unlit[3])  # light scales colour only
    assert float((lit[:3] - unlit[:3]).abs().max()) > 1e-2
    assert float((nearest - unlit).abs().max()) > 1e-3


def test_prepare_composite_mode_operands():
    """Outside lit mode no light planes are built; intensity marks every
    chunk occupied; a lit frame without depth keeps composite's defaults."""
    _, pp = _plans(CAMS[0])
    vol = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0))
    tf = torch.from_numpy(np.array(JT.tf_ct_bone()))
    c = PS.ClipPlane.disabled()
    win = torch.tensor([0.95, 0.05, 1.0, 1.0])  # a window few chunks reach
    lit = PC.prepare_composite(vol, tf, torch.from_numpy(_light()), pp, win,
                               c.center, c.direction)
    assert "mode" not in lit and "depth_lam" not in lit
    assert not bool(lit["occ"].all())
    for mode in ("unlit", "intensity"):
        ops = PC.prepare_composite(vol, tf, None, pp, win, c.center,
                                   c.direction, mode=mode,
                                   depth_lam=np.ones((pp.n1, pp.n2)))
        assert ops["L"] is None and ops["mode"] == mode
        assert ops["depth_lam"].dtype == torch.float32
        assert bool(ops["occ"].all()) == (mode == "intensity")
    with pytest.raises(ValueError, match="unknown mode"):
        PC.prepare_composite(vol, tf, None, pp, win, c.center, c.direction,
                             mode="octree")


@pytest.mark.parametrize("cam_pos", CAMS)
@pytest.mark.parametrize("dims,max_planes", [(DIMS, PLANES), (DIMS, None),
                                             ((32, 32, 24), 17)])
def test_nearest_resample_block_exact(cam_pos, dims, max_planes):
    """`_volume_planes` and `_resample_block` with ``nearest=True`` select
    the same texels as the JAX package's, so the planes are equal."""
    jp, pp = _plans(cam_pos, dims, max_planes)
    vol = synthetic.ct_like_phantom(dims, seed=3)
    ax = (pp.axis,) + tuple(pp.axes12)
    want_planes = JSW._volume_planes(jnp.transpose(jnp.asarray(vol), ax), jp,
                                     nearest=True)
    want = np.asarray(JSW._resample_block(
        want_planes, jp.a1, jp.b1, jp.a2, jp.b2, jp.n1, jp.n2, jnp.float32,
        nearest=True))
    planes = PSW._volume_planes(torch.from_numpy(vol).permute(ax), pp,
                                nearest=True)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want_planes))
    got = PSW._resample_block(
        planes, *(PSW._t(getattr(pp, n), "cpu") for n in ("a1", "b1", "a2",
                                                         "b2")),
        pp.n1, pp.n2, torch.float32, nearest=True).numpy()
    np.testing.assert_array_equal(got, want)
    # one-hot on both axes: every output is a texel of its plane
    assert np.isin(got[0], planes[0].numpy()).all()


@pytest.mark.parametrize("cam_pos", CAMS)
def test_depth_to_lambda_max_matches_jax(cam_pos):
    """A plane through the volume, partly behind the camera (inf depth)."""
    jp, pp = _plans(cam_pos)
    jcam = JS.Camera.look_at(list(cam_pos), [0.0, 0.0, 0.0], fov_degrees=40.0)
    depth = np.array(JR.scene_depth_from_plane(
        jcam, JS.VolumeTransform.create(), W, H, [0.1, 0.0, 0.0],
        [0.3, 0.9, 0.2]))
    depth[: H // 4] = np.inf  # rows the scene leaves open
    want = np.asarray(JSW.depth_to_lambda_max(jp, jnp.asarray(depth), W, H))
    got = PSW.depth_to_lambda_max(pp, torch.from_numpy(depth), W, H).numpy()
    assert got.shape == (pp.n1, pp.n2) and got.dtype == np.float32
    assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
