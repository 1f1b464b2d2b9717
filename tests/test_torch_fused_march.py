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
from tbraymarcherplugin_tpu.ops import octree as JO
from tbraymarcherplugin_tpu.ops import pallas_march as JPM
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import fused_march as FM
from tbraymarcherplugin_tpu_torch.ops import march as PM
from tbraymarcherplugin_tpu_torch.ops import octree as PO
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import transfer as PT
from tbraymarcherplugin_tpu_torch.ops.rays import (RayBatch, jitter_values,
                                                   setup_rays)
from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
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
        assert stats["steps"] == stats["samples"] == stats["fetches"] == every
        assert stats["cut"] == stats["zero_alpha"] == 0
    else:
        assert (img[..., 3] == 1.0).any()  # some rays snap
        assert 0 < stats["samples"] < stats["steps"] < every
        assert 0 < stats["cut"] and 0 < stats["zero_alpha"]
        # without a grid every unclipped sample is fetched
        assert stats["fetches"] == stats["samples"] + stats["cut"]
    # the samples the bound charges with the light: those of alpha above 0
    assert stats["shaded"] == stats["samples"] - stats["zero_alpha"]
    assert "empty" not in stats
    for k in ("steps", "samples", "fetches"):
        assert stats[k] <= stats["warp_" + k] <= 32 * stats[k]


def _fields(H, W, steps, seed=0):
    """(8, H, W) march fields of a camera inside a 24^3 phantom, with the
    phantom, the bone TF, a random light volume, the window (0.5, 0.8, low
    cutoff on) and a clip plane."""
    vol = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=seed))
    cam = PS.Camera.look_at((0.1, -0.3, 0.05), (0.0, 0.0, 0.0),
                            fov_degrees=60.0)
    rays = setup_rays(cam, PS.VolumeTransform.create(), W, H)
    win = torch.tensor([0.5, 0.8, 1.0, 0.0])
    ch, params = FM._march_inputs(vol, rays, win, (0.5, 0.45, 0.5),
                                  (0.3, 0.8, 0.52), jitter_values(W, H, 1),
                                  steps)
    lv = torch.from_numpy(
        np.random.default_rng(seed).random((12, 12, 12), np.float32))
    return ch, params, vol, lv, PT.tf_ct_bone(), win


def test_plain_march_warp_counts_match_brute_force():
    """The per-warp counts of ``stats`` on a ragged 9x20 batch (a warp is a
    tile of 4 rows of 8 pixels of a 16x16 block) against each ray marched
    alone."""
    H, W, steps = 9, 20, 24
    ch, params, vol, lv, tf, _ = _fields(H, W, steps)
    stats = {}
    FM._march_plain(ch, vol, lv, tf, params, steps, 0.95, True, stats)
    per_ray = {}
    for y in range(H):
        for x in range(W):
            one = {}
            FM._march_plain(ch[:, y:y + 1, x:x + 1], vol, lv, tf, params,
                            steps, 0.95, True, one)
            per_ray[y, x] = one
    for k in ("steps", "samples", "fetches"):
        assert stats[k] == sum(r[k] for r in per_ray.values())
        warps = {}
        for (y, x), r in per_ray.items():
            w = (y // 4, x // 8)
            warps[w] = max(warps.get(w, 0), r[k])
        assert stats["warp_" + k] == 32 * sum(warps.values())
    assert stats["warp_steps"] > stats["steps"] > stats["samples"] > 0


@pytest.mark.parametrize("inside", [True, False])
@pytest.mark.parametrize("win", [(0.5, 0.8, 1.0, 0.0), (0.65, 0.5, 1.0, 1.0)])
def test_plain_march_skipping_empty_cells_keeps_the_bits(inside, win):
    """K9's plain version with the renderer's occupancy grid (margin for the
    lerps' rounding) against the one without, at 24^3 with a clip plane and
    jitter, from inside and outside the volume: the same bits, and cells
    are skipped."""
    vol = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    tf, w = PT.tf_ct_bone(), torch.tensor(win)
    pos = (0.1, -0.3, 0.05) if inside else (0.1, -2.3, 0.4)
    cam = PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=60.0)
    rays = setup_rays(cam, PS.VolumeTransform.create(), 48, 32)
    lv = torch.from_numpy(
        np.random.default_rng(3).random((24, 24, 24), np.float32))
    occ = PO.occupancy_grid(PO.build_octree(vol), w, tf, mip=1)
    args = (vol, tf, lv, rays, w, (0.5, 0.45, 0.5), (0.3, 0.8, 0.52))
    kw = dict(jitter=jitter_values(48, 32, 2), step_count=40)
    on, off = {}, {}
    got = FM.march_lit_fused_plain(*args, **kw, occupancy=occ, stats=on)
    want = FM.march_lit_fused_plain(*args, **kw, stats=off)
    assert float(want[..., 3].max()) > 0.5
    assert torch.equal(got, want)
    assert on["empty"] > 0 and on["fetches"] < off["fetches"]
    assert on["steps"] == off["steps"] and on["samples"] == off["samples"]
    assert on["shaded"] == off["shaded"] < off["samples"]


def test_occupancy_margin_holds_against_lerp_rounding():
    """A rounded trilinear sample of a constant volume can exceed the
    constant by an ulp (a fifth of the samples of 0.41 do). With a window
    that puts the constant just below the texel where the TF's alpha turns
    on, the JAX package's grid (no margin) marks the cells empty though
    such samples have alpha above 0, and a march that skipped by it would
    lose them; the grid with ``LERP_MARGIN`` keeps the cells and the
    bits."""
    v = np.float32(0.41)
    up = np.nextafter(v, np.float32(1.0))
    width = np.float32(1e-4)
    tf = torch.zeros(256, 4)
    tf[130:] = 1.0  # alpha 0 up to texel 129, 1 from texel 130

    def x(value, center):  # the kernel's TF coordinate, in float32
        t = (value - center + width * np.float32(0.5)) / width
        return np.float32(t * np.float32(256.0) - np.float32(0.5))

    center = np.float32(v + width * np.float32(0.5)
                        - np.float32(128.9 / 256.0) * width)
    while not (x(v, center) < 129.0 <= x(up, center)):
        center = np.nextafter(center, np.float32(0.0) if x(v, center) < 129.0
                              else np.float32(1.0))
    # one sample per ray (n_full 1, step 0, no final step)
    n = 512
    pos = np.random.default_rng(5).uniform(0.05, 0.95, (3, 1, n))
    ch = torch.cat([torch.from_numpy(pos.astype(np.float32)),
                    torch.zeros(3, 1, n), torch.ones(1, 1, n),
                    torch.zeros(1, 1, n)])
    params = torch.tensor([float(center), float(width), 0.0, 0.0,
                           0.0, 0.0, -1e6, 0.0, 0.0, 1.0])
    vol = torch.full((16, 16, 16), float(v))

    def march(occupancy=None):
        return FM._march_plain(ch, vol, torch.ones(8, 8, 8), tf, params, 20,
                               0.95, True, occupancy=occupancy)

    want = march()
    assert float(want[..., 3].max()) > 0.0  # samples above the constant
    win = params[:4]
    jgrid = JO.occupancy_grid(JO.build_octree(jnp.asarray(vol.numpy())),
                              jnp.asarray(win.numpy()),
                              jnp.asarray(tf.numpy()), mip=2)
    bare = PO.OccupancyGrid(grid=torch.from_numpy(np.array(jgrid.grid)),
                            cell_scale=tuple(jgrid.cell_scale))
    assert not bool(bare.grid.any())
    assert float(march(bare)[..., 3].max()) == 0.0
    held = PO.occupancy_grid(PO.build_octree(vol), win, tf, mip=2)
    assert bool(held.grid.all())
    assert torch.equal(march(held), want)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_renderer_march_skips_empty_space_exactly(impl):
    """The renderer's K9 branch with ``empty_space_skipping`` (its default)
    builds the occupancy grid on its second frame, takes it cached from
    then on and renders the same bits as without, at 64^3 from inside the
    volume, jittered, with a clip plane."""
    vol = synthetic.ct_like_phantom((64, 64, 64), seed=0)
    cam = PS.Camera.look_at((0.1, -0.3, 0.05), (0.0, 0.0, 0.0),
                            fov_degrees=60.0)
    imgs = []
    for ess in (True, False):
        r = Renderer(vol, tf_table=PT.tf_ct_bone(),
                     clip_plane=PS.ClipPlane((0.0, 0.05, 0.0),
                                             (0.3, 0.8, 0.52)),
                     config=RendererConfig(step_count=40, march_impl=impl,
                                           empty_space_skipping=ess),
                     device="cpu")
        r.add_light("sun", PS.DirLight.create((0.3, 0.1, -0.95), 1.0))
        imgs.append(r.render(cam, 48, 32))
        assert r._occ is None  # not on the first frame
        imgs.append(r.render(cam, 48, 32))
        assert (r._occ is not None) == ess
        if ess:
            assert r.occupancy() is r._occ  # cached
            assert not bool(r._occ.grid.all())
    assert float(imgs[3][..., 3].max()) > 0.5
    # frame by frame (the jitter moves with the frame)
    assert torch.equal(imgs[0], imgs[2]) and torch.equal(imgs[1], imgs[3])


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
