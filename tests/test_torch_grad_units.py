"""The backward units of the port's differentiable path on the CPU: K8 (TF
alpha), K7 (propagation scan, with d alpha) and K6 (row lerp, and the
whole screen warp) through their autograd functions, against the JAX
package's custom VJPs (Pallas in interpret mode). The CUDA kernels are held
to the plain versions these tests reach in `test_torch_kernels.py`.

Tolerances are the JAX package's own gradient tests' (rtol 2e-4, atol
2e-5 of the largest reference value): the sums run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.pallas_lighting import (
    propagate_face_scan as jscan,
)
from tbraymarcherplugin_tpu.ops.pallas_tf import windowed_tf_alpha_vjp as jtf
from tbraymarcherplugin_tpu.ops.pallas_warp import banded_row_lerp
from tbraymarcherplugin_tpu.ops.pallas_warp import warp_to_screen_fused as jwarp
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import light_scan as PK4
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import tf_alpha as PK3
from tbraymarcherplugin_tpu_torch.ops import warp as PW
from test_torch_shearwarp import smooth_image

WINDOWS = ([0.45, 0.7, 1.0, 1.0], [0.5, 1.2, 0.0, 0.0], [0.8, 0.3, 1.0, 0.0])


def assert_grad_close(got, want, name, rtol=2e-4, atol=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=name)


def _leaf(x):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_()


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("step", [0.73, 1.9])
def test_tf_alpha_vjp_matches_jax(rng, win, step):
    # the bone TF's alpha plateaus at exactly 0 give the clip's ties (its
    # 0.5 subgradient); the values spread past both cutoffs
    vals = rng.random((9, 7, 13), dtype=np.float32) * 1.4 - 0.2
    tf = np.array(JT.tf_ct_bone())
    g = rng.standard_normal(vals.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda v, t, w: jtf(v, t, w, step, interpret=True),
                       jnp.asarray(vals), jnp.asarray(tf),
                       jnp.asarray(win, jnp.float32))
    want = vjp(jnp.asarray(g))
    v, t, w = _leaf(vals), _leaf(tf), _leaf(win)
    got = PK3.windowed_tf_alpha_vjp(v, t, w, step)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6)
    got.backward(torch.from_numpy(g))
    assert np.abs(np.asarray(want[0])).max() > 0
    for name, a, b in zip(("dval", "dtf", "dwin"), (v.grad, t.grad, w.grad),
                          want):
        assert_grad_close(a, b, name)
    assert float(t.grad[:, :3].abs().max()) == 0.0  # alpha column only


@pytest.mark.parametrize(
    "shape,off",
    [((12, 16, 16), (0.37, -1.6)), ((9, 24, 40), (-3.1, 4.9)),
     ((7, 20, 12), (-10.4, 0.6)), ((1, 16, 16), (0.5, 0.5))],
)
def test_scan_vjp_matches_jax(rng, shape, off):
    op = rng.random(shape, dtype=np.float32) * 0.6
    g = rng.standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda o, a: jscan(o, off[0], off[1], a, interpret=True),
        jnp.asarray(op), jnp.float32(0.83))
    want = vjp(jnp.asarray(g))
    o, a = _leaf(op), _leaf(0.83)
    got = PK4.propagate_face_scan_vjp(o, off[0], off[1], a)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    got.backward(torch.from_numpy(g))
    assert_grad_close(o.grad, want[0], "d opacity")
    assert_grad_close(a.grad, want[1], "d alpha")


def test_row_lerp_vjp_matches_jax(rng):
    """Four channel groups sharing one index array, indices past both
    edges; spread within the TPU kernel's band, where both are exact."""
    groups, rq, n, q = 4, 16, 200, 300
    rows = rng.random((groups * rq, n), dtype=np.float32)
    idx = (np.linspace(-3.0, n + 3.0, q)[None, :]
           + rng.random((rq, q)) * 2.0).astype(np.float32)
    g = rng.standard_normal((groups * rq, q)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda r: banded_row_lerp(r, jnp.asarray(idx), True, groups),
        jnp.asarray(rows))
    (want,) = vjp(jnp.asarray(g))
    r = _leaf(rows)
    PW.row_lerp_vjp(r, torch.from_numpy(idx), groups).backward(
        torch.from_numpy(g))
    assert_grad_close(r.grad, want, "d rows")


@pytest.mark.parametrize("size", [(64, 48), (93, 61)])
@pytest.mark.parametrize("pos", [(0.3, -2.1, 0.6), (2.1, 0.7, 0.9)])
def test_warp_vjp_matches_jax(rng, size, pos):
    """Both passes of the channel-major screen warp, including the
    validity mask; sizes that are not multiples of 8."""
    w, h = size
    args = (pos, (0.0, 0.0, 0.0))
    jp = JSW.plan_shearwarp(JS.Camera.look_at(*args, fov_degrees=40.0),
                            JS.VolumeTransform.create(), (24,) * 3, (24,) * 3,
                            w, h, max_n=64)
    pp = PSW.plan_shearwarp(PS.Camera.look_at(*args, fov_degrees=40.0),
                            PS.VolumeTransform.create(), (24,) * 3, (24,) * 3,
                            w, h, max_n=64)
    inter = np.ascontiguousarray(
        smooth_image(rng, pp.n1, pp.n2).transpose(2, 0, 1))
    g = smooth_image(rng, w, h).transpose(1, 0, 2).copy()  # (h, w, 4)
    _, vjp = jax.vjp(lambda x: jwarp(x, jp, w, h, interpret=True,
                                     channel_major=True), jnp.asarray(inter))
    (want,) = vjp(jnp.asarray(g))
    x = _leaf(inter)
    PW.warp_to_screen_fused(x, pp, w, h).backward(torch.from_numpy(g))
    assert np.abs(np.asarray(want)).max() > 0
    assert_grad_close(x.grad, want, "d intermediate")
