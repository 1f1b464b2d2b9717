"""K3 (windowed TF alpha), K4 (light scan) and the illumination rebuild:
the port's plain versions vs the JAX package's Pallas kernels (interpret
mode) on the CPU. The CUDA kernels are held to the plain versions in
`test_torch_kernels.py`."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu.ops import lighting as JL
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.pallas_lighting import (
    _scan_bwd_pallas,
    propagate_face_scan_pallas,
)
from tbraymarcherplugin_tpu.ops.pallas_tf import windowed_tf_alpha as jalpha
from tbraymarcherplugin_tpu_torch.ops import light_scan as PK4
from tbraymarcherplugin_tpu_torch.ops import lighting as PL
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import tf_alpha as PK3

WINDOWS = ([0.45, 0.7, 1.0, 1.0], [0.5, 1.2, 0.0, 0.0], [0.8, 0.3, 1.0, 0.0])
NO_CLIP = (np.array([0.0, 0.0, -1e6], np.float32),
           np.array([0.0, 0.0, 1.0], np.float32))
CLIP = (np.array([0.5, 0.45, 0.5], np.float32),
        np.array([0.3, 0.8, 0.52], np.float32) / np.float32(
            np.linalg.norm([0.3, 0.8, 0.52])))


def _tf():
    return np.array(JT.tf_ct_bone())


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("step", [0.73, 1.9])
def test_tf_alpha_plain_matches_jax(rng, win, step):
    vals = rng.random((13, 9, 21), dtype=np.float32) * 1.4 - 0.2
    tf = _tf()
    want = np.asarray(jalpha(jnp.asarray(vals), jnp.asarray(tf),
                             jnp.asarray(win, jnp.float32), step,
                             interpret=True))
    got = PK3.windowed_tf_alpha(torch.from_numpy(vals), torch.from_numpy(tf),
                                win, step).numpy()
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "shape,off",
    [
        ((12, 16, 16), (0.37, -1.6)),
        ((5, 8, 8), (2.25, 1.75)),
        ((9, 24, 40), (-3.1, 4.9)),
        ((7, 20, 12), (-10.4, 0.6)),
        ((1, 16, 16), (0.5, 0.5)),
    ],
)
def test_scan_plain_matches_jax(rng, shape, off):
    op = rng.random(shape, dtype=np.float32) * 0.6
    want = np.asarray(propagate_face_scan_pallas(
        jnp.asarray(op), off[0], off[1], 0.83, interpret=True))
    got = PK4.propagate_face_scan(torch.from_numpy(op), off[0], off[1],
                                  0.83).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "shape,off",
    [
        ((6, 16, 16), (0.37, -1.6)),
        ((7, 20, 12), (-10.4, 0.6)),  # the row shift spans many bands
        ((5, 12, 30), (11.3, -6.8)),
        ((1, 8, 8), (0.5, 0.5)),
    ],
)
def test_scan_bwd_plain_matches_jax(rng, shape, off):
    """K7's plain version against the JAX package's reverse-scan kernel
    (interpret mode): every d opacity, sum m and m_0, on non-square faces
    with row shifts of both signs up to 11 px."""
    op = rng.random(shape, dtype=np.float32) * 0.6
    g = rng.standard_normal(shape).astype(np.float32)
    y = np.array(propagate_face_scan_pallas(
        jnp.asarray(op), off[0], off[1], 0.83, interpret=True))
    want = _scan_bwd_pallas(jnp.asarray(g), jnp.asarray(op), jnp.asarray(y),
                            off[0], off[1], 0.83, True)
    got = PK4.propagate_face_scan_bwd(
        torch.from_numpy(g), torch.from_numpy(op), torch.from_numpy(y),
        off[0], off[1], 0.83)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("face", range(6))
def test_propagate_one_face_matches_jax(rng, face):
    """Every face class (axis, direction), lateral offsets above 1 px, a
    half-resolution light volume and an active clip plane."""
    vol = rng.random((16, 16, 16), dtype=np.float32)
    tf = _tf()
    win = [0.5, 1.0, 0.0, 0.0]
    uv, uvw, step, alpha = [0.21, -0.17], [0.05, -0.03, 0.04], 0.011, 0.9
    want = np.asarray(JL._propagate_one_face(
        jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(win, jnp.float32),
        jnp.asarray(CLIP[0]), jnp.asarray(CLIP[1]),
        jnp.asarray(uv, jnp.float32), jnp.asarray(uvw, jnp.float32),
        jnp.asarray(step, jnp.float32), jnp.asarray(alpha, jnp.float32),
        face, (8, 8, 8), True, scan_impl="pallas",
    ))
    got = PL._propagate_one_face(
        torch.from_numpy(vol), torch.from_numpy(tf), win, CLIP[0], CLIP[1],
        uv, uvw, step, np.float32(alpha), face, (8, 8, 8), True,
    ).numpy()
    assert abs(uv[0] * 8) > 1 and abs(uv[1] * 8) > 1
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _light_scene():
    vol = synthetic.ct_like_phantom((24, 24, 24), seed=0)
    return vol, _tf(), [0.5, 0.8, 1.0, 1.0]


@pytest.mark.parametrize("light_dims", [(24, 24, 24), (12, 12, 12)])
@pytest.mark.parametrize("direction", [(0.3, 0.1, -0.95), (-0.7, 0.6, 0.2)])
@pytest.mark.parametrize("clip", [NO_CLIP, CLIP])
def test_add_dir_light_matches_jax(light_dims, direction, clip):
    vol, tf, win = _light_scene()
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    lv0 = np.full(light_dims, 0.05, np.float32)
    want = np.asarray(JL.add_dir_light(
        jnp.asarray(lv0), jnp.asarray(vol), jnp.asarray(tf),
        jnp.asarray(win, jnp.float32), jnp.asarray(clip[0]),
        jnp.asarray(clip[1]), d, 0.8, scan_impl="pallas"))
    got = PL.add_dir_light(
        torch.from_numpy(lv0), torch.from_numpy(vol), torch.from_numpy(tf),
        win, clip[0], clip[1], d, 0.8).numpy()
    assert want.max() > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("light_dims", [(24, 24, 24), (12, 12, 12)])
def test_change_dir_light_matches_jax(light_dims):
    vol, tf, win = _light_scene()
    old = np.asarray([0.3, 0.1, -0.95], np.float32)
    new = np.asarray([0.1, 0.5, -0.8], np.float32)
    old, new = old / np.linalg.norm(old), new / np.linalg.norm(new)
    lv0 = np.asarray(JL.add_dir_light(
        jnp.zeros(light_dims, jnp.float32), jnp.asarray(vol),
        jnp.asarray(tf), jnp.asarray(win, jnp.float32),
        jnp.asarray(NO_CLIP[0]), jnp.asarray(NO_CLIP[1]), old, 1.0,
        scan_impl="pallas"))
    want = np.asarray(JL.change_dir_light(
        jnp.asarray(lv0), jnp.asarray(vol), jnp.asarray(tf),
        jnp.asarray(win, jnp.float32), jnp.asarray(NO_CLIP[0]),
        jnp.asarray(NO_CLIP[1]), old, 1.0, new, 0.7, scan_impl="pallas"))
    got = PL.change_dir_light(
        torch.from_numpy(lv0.copy()), torch.from_numpy(vol),
        torch.from_numpy(tf), win, *NO_CLIP, old, 1.0, new, 0.7).numpy()
    assert np.abs(want - lv0).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_axis_math_matches_jax():
    for d in ([0.3, 0.1, -0.95], [-0.7, 0.6, 0.2], [0.0, 0.0, 1.0],
              [0.05, 0.999, 0.01]):
        assert PL.local_light_major_axes(d) == tuple(
            JL.local_light_major_axes(d))
        axes = PL.local_light_major_axes(d)
        for face, w in zip(axes.faces, axes.weights):
            if w > 0.0:  # the faces a light propagates along
                assert PL.plan_face_propagation(face, d, (24, 20, 28), w) \
                    == JL.plan_face_propagation(face, d, (24, 20, 28), w)

