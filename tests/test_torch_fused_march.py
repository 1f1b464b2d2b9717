"""K9's entry point `ops/fused_march.py::march_lit_fused` on the CPU, where
it runs its plain version, against the JAX package's fused TPU march
(`pallas_march.march_lit_pallas`, Pallas in interpret mode, on the
pencil-swizzled inputs) and its step-by-step `march_lit`, on the same numpy
inputs.

Tolerances are the JAX package's own for its fused march
(`tests/test_pallas_march.py`): rtol 1e-4, atol 5e-5, and atol 1e-3 with a
clip plane (the dot product associates differently, so a sample on the
plane can flip). The TPU kernel composites 4-step segments by cumulative
products and `march_lit` sums positions step by step; K9 does neither.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tbraymarcherplugin_tpu.ops import march as JM
from tbraymarcherplugin_tpu.ops import pallas_march as JPM
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch.ops import fused_march as FM
from tbraymarcherplugin_tpu_torch.ops import march as PM
from tbraymarcherplugin_tpu_torch.ops.rays import RayBatch
from test_torch_march import NO_CLIP, _jax, _port, _scene, _t

RTOL, ATOL, CLIP_ATOL = 1e-4, 5e-5, 1e-3


def _pallas(s, **kw):
    rays = JM.RayBatch(*(jnp.asarray(x) for x in s["rays"]))
    jit = None if s["jit"] is None else jnp.asarray(s["jit"])
    return np.asarray(JPM.march_lit_pallas(
        JPM.swizzle_volume(jnp.asarray(s["vol"])), jnp.asarray(s["tf"]),
        JPM.swizzle_volume(jnp.asarray(s["lv"])), rays,
        jnp.asarray(s["win"]), jnp.asarray(s["cc"]), jnp.asarray(s["cd"]),
        jitter=jit, interpret=True, **kw))


def _translucent(s):
    """Every ray runs to its fractional final step."""
    s["vol"] = np.full((16, 16, 16), 0.3, np.float32)
    s["lv"] = np.ones((8, 8, 8), np.float32)
    s["tf"] = np.asarray(JT.tf_from_keypoints(
        [0.0, 1.0], [[0, 0, 0, 0], [1.0, 1.0, 1.0, 0.05]]))
    return s


def test_fused_march_matches_pallas_with_clip_and_half_res_light():
    """Clip plane, low cutoff, jitter; the 16x14x8 light volume is the
    33x28x17 volume's half resolution."""
    s = _scene()
    assert s["lv"].shape == tuple(d // 2 for d in s["vol"].shape)
    kw = dict(step_count=24)
    got = _port(FM.march_lit_fused, s, **kw)
    assert FM.march_lit_fused.launches == 0  # the CPU runs the plain version
    want = _pallas(s, **kw)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CLIP_ATOL)
    np.testing.assert_allclose(got, _jax(JM.march_lit, s, **kw), rtol=RTOL,
                               atol=CLIP_ATOL)


@pytest.mark.parametrize("compat", [True, False])
def test_fused_march_final_step_flag(compat):
    s = _translucent(_scene(img=(16, 16), clip=NO_CLIP,
                            win=(0.5, 1.0, 1.0, 1.0)))
    kw = dict(step_count=49, compat_final_step=compat)
    got = _port(FM.march_lit_fused, s, **kw)
    np.testing.assert_allclose(got, _jax(JM.march_lit, s, **kw), rtol=RTOL,
                               atol=ATOL)
    if compat:  # the interpreter is the slow part: one flag is enough
        np.testing.assert_allclose(got, _pallas(s, **kw), rtol=RTOL,
                                   atol=ATOL)
    other = _port(FM.march_lit_fused, s, step_count=49,
                  compat_final_step=not compat)
    assert not np.allclose(got, other)  # the flag matters on this scene


def test_fused_march_matches_port_blocked_march():
    """K9's plain version against the port's blocked march (the same sample
    positions, another compositing order) at the renderer's 150 steps, with
    early termination."""
    s = _scene()
    s["tf"] = np.asarray(JT.tf_from_keypoints(
        [0, 0.5, 1], [[0, 0, 0, 0], [0.5, 0.4, 0.3, 0.6], [1, 1, 1, 1]]))
    kw = dict(step_count=150)
    got = _port(FM.march_lit_fused, s, **kw)
    want = _port(PM.march_lit_blocked, s, **kw)
    assert (want[..., 3] == 1.0).any()  # some rays snap
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=CLIP_ATOL)


@pytest.mark.parametrize("case", ["translucent", "clip_cut_snap"])
def test_plain_march_counts_the_kernels_work(case):
    """``stats`` counts the steps K9's threads take and the samples they
    light: every step of every ray and its final one when no ray ends
    early and nothing is clipped or cut; fewer steps once rays snap, and
    fewer lit samples than steps with a clip plane and a low cutoff."""
    if case == "translucent":
        s = _translucent(_scene(img=(16, 16), clip=NO_CLIP,
                                win=(0.5, 1.0, 1.0, 1.0)))
        steps = 49
    else:
        s = _scene()
        s["tf"] = np.asarray(JT.tf_from_keypoints(
            [0, 0.5, 1], [[0, 0, 0, 0], [0.5, 0.4, 0.3, 0.6], [1, 1, 1, 1]]))
        steps = 150
    stats = {}
    img = _port(FM.march_lit_fused_plain, s, step_count=steps, stats=stats)
    np.testing.assert_array_equal(
        img, _port(FM.march_lit_fused_plain, s, step_count=steps))
    rays = RayBatch(*(_t(x) for x in s["rays"]))
    jit = None if s["jit"] is None else _t(s["jit"])
    ch, _ = FM._march_inputs(_t(s["vol"]), rays, _t(s["win"]), s["cc"],
                             s["cd"], jit, steps)
    every = int(ch[6].nan_to_num(0.0).clamp(min=0.0).ceil().sum()
                + (ch[7] > 0.0).sum())
    if case == "translucent":
        assert stats == dict(steps=every, samples=every)
    else:
        assert (img[..., 3] == 1.0).any()  # some rays snap
        assert 0 < stats["samples"] < stats["steps"] < every


def test_fused_march_is_forward_only():
    s = _scene(img=(8, 8))
    rays = RayBatch(*(_t(x) for x in s["rays"]))
    vol = _t(s["vol"]).requires_grad_()
    args = (vol, _t(s["tf"]), _t(s["lv"]), rays, _t(s["win"]), s["cc"],
            s["cd"])
    with pytest.raises(RuntimeError, match="forward-only"):
        FM.march_lit_fused(*args, step_count=8)
    with torch.no_grad():
        img = FM.march_lit_fused(*args, step_count=8)
    assert img.shape == (8, 8, 4) and not img.requires_grad
    with pytest.raises(ValueError, match=r"\(H, W\) ray batch"):
        flat = RayBatch(rays.entry.reshape(-1, 3),
                        rays.direction.reshape(-1, 3),
                        rays.thickness.reshape(-1))
        with torch.no_grad():
            FM.march_lit_fused(vol, *args[1:3], flat, *args[4:])
