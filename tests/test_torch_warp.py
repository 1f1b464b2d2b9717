"""K2 (the screen-warp row lerp): the port's plain version vs the JAX
package's warps on the CPU. The CUDA kernel is held to the plain version
in `test_torch_kernels.py`."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops.pallas_warp import warp_to_screen_fused as jwarp
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import warp as PW
from test_torch_shearwarp import smooth_image

DIMS = (24, 24, 24)


def _plans(w, h, pos=(0.1, -2.3, 0.4), up=(0.0, 0.0, 1.0), **kw):
    args = (pos, (0.0, 0.0, 0.0))
    jc = JS.Camera.look_at(*args, up=up, fov_degrees=40.0)
    pc = PS.Camera.look_at(*args, up=up, fov_degrees=40.0)
    kw.setdefault("max_n", 64)
    return (JSW.plan_shearwarp(jc, JS.VolumeTransform.create(), DIMS, DIMS,
                               w, h, **kw),
            PSW.plan_shearwarp(pc, PS.VolumeTransform.create(), DIMS, DIMS,
                               w, h, **kw))


@pytest.mark.parametrize("size", [(64, 48), (93, 61), (100, 52)])
@pytest.mark.parametrize("up", [(0.0, 0.0, 1.0), (0.35, 0.2, 0.91)])
def test_fused_warp_plain_matches_jax(rng, size, up):
    """Channel-major warp, including sizes that are not multiples of 8."""
    w, h = size
    jp, pp = _plans(w, h, pos=(0.3, -2.1, 0.6), up=up)
    inter = np.ascontiguousarray(
        smooth_image(rng, pp.n1, pp.n2).transpose(2, 0, 1))  # (4, n1, n2)
    want = np.asarray(jwarp(jnp.asarray(inter), jp, w, h, interpret=True,
                            channel_major=True))
    got = PW.warp_to_screen_fused(torch.from_numpy(inter), pp, w, h).numpy()
    assert got.shape == (h, w, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.max() > 0.05


def test_fused_warp_plain_matches_xla_warp_beyond_band(rng):
    """A grid three times finer than the plan's: pass-1 rows span more
    than the TPU kernel's 254-texel band; the port has no band and stays
    equal to the JAX package's plain XLA warp."""
    w, h = 64, 48
    jp, pp = _plans(w, h)
    d1 = np.float32(np.float32(pp.d1) / np.float32(3.0))
    jp = dataclasses.replace(jp, n1=3 * jp.n1, d1=jnp.float32(d1))
    pp = dataclasses.replace(pp, n1=3 * pp.n1, d1=d1)
    p1r, p2r, pdr, W, _ = PSW.warp_rows(pp, w, h)
    idx1 = PW.pass1_index(pp, W, p1r, p2r, pdr).clamp(0, pp.n1 - 1)
    assert float((idx1.amax(1) - idx1.amin(1)).max()) > 254
    inter = smooth_image(rng, pp.n1, pp.n2)
    want = np.asarray(JSW.warp_to_screen(jnp.asarray(inter), jp, w, h))
    got = PW.warp_to_screen_fused(
        torch.from_numpy(np.ascontiguousarray(inter.transpose(2, 0, 1))),
        pp, w, h).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _wide_rows(rng, groups=4, rq=12, n=2048, q=300):
    rows = rng.random((groups * rq, n), dtype=np.float32)
    idx = (np.linspace(-40.0, n + 40.0, q)[None, :]
           + rng.random((rq, q)) * 5.0).astype(np.float32)
    return rows, idx


def test_row_lerp_plain_matches_lerp_take_any_spread(rng):
    """Index spread ~2000 texels per row, ends past the row (clamp)."""
    rows, idx = _wide_rows(rng)
    want = np.asarray(JSW._lerp_take(
        jnp.asarray(rows), jnp.asarray(np.tile(idx, (4, 1)))))
    got = PW.row_lerp(torch.from_numpy(rows), torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(got.numpy(), want)



@pytest.mark.parametrize("groups", [1, 4])
def test_grid_sampler_backward_is_the_row_lerp_adjoint(rng, groups):
    """K6's yardstick in `chip_smoke.py`: `grid_sampler_2d_backward` (the
    input gradient only) on `row_lerp_library_args`'s arguments computes
    `row_lerp_bwd_plain`. grid_sample maps its coordinate back to texels in
    float32; with N - 1 a power of two and indices on a 1/64-texel grid
    (clamped ends included) that mapping is exact, so both take the same
    taps and weights and differ only in the order of their sums: within
    1e-5 of the largest value, the backward kernels' limit."""
    import chip_smoke as CS

    n, rq, q = 65, 9, 300
    idx = torch.from_numpy((np.round(
        (rng.random((rq, q)) * (n + 10.0) - 5.0) * 64.0) / 64.0).astype(
            np.float32))
    g = torch.from_numpy(rng.standard_normal((groups * rq, q)).astype(
        np.float32))
    rows = torch.zeros((groups * rq, n))
    inp, grid = CS.row_lerp_library_args(torch, rows, idx, groups)
    got = torch.ops.aten.grid_sampler_2d_backward(
        g.view(groups, 1, rq, q), inp, grid, 0, 1, True, [True, False])[0]
    want = PW.row_lerp_bwd_plain(g, idx, n, groups)
    assert got.shape == (groups, 1, rq, n)
    err = float((got.reshape(want.shape) - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
