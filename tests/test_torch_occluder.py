"""The occluder field of one light face
(`ops.lighting.occluder_opacity_volume`): K3's occluder source samples
the volume, tests the cube, weights the clip plane and takes the windowed
TF alpha in one launch.

On the CPU, the plain version and the differentiable unit against the
composition the field was before the kernel made its own input (the
shifted slices of a padded volume, the stacked UVW field, the clip weight
and the cube test in PyTorch around K3 on the values, `_parent_occluder`
below), bit for bit, values and gradients. On the card (skipped without a
CUDA device), the kernel against the plain version, gradients through
`compute_illumination` against the parent composition's, and its launch
count.

This file imports no JAX: on the machine with the card run it as

    python -m pytest tests/test_torch_occluder.py -q --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import lighting as PL
from tbraymarcherplugin_tpu_torch.ops import sampling as S
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import tf_alpha as PK3
from tbraymarcherplugin_tpu_torch.ops import transfer as T

VOL = (40, 36, 28)  # non-cubic, every axis even
LIGHT = {1: VOL, 2: (20, 18, 14), "uneven": (16, 12, 20)}
WIN = [0.45, 0.7, 1.0, 1.0]
CLIPS = {
    "cross": ([0.5, 0.45, 0.5], [0.3, 0.8, 0.52]),
    "miss": ([0.0, 0.0, -1e6], [0.0, 0.0, 1.0]),  # ClipPlane.disabled()
    "flat": ([0.0, 0.5, 0.5], [1.0, 0.0, 0.0]),   # along the x = 0 face
}
# a light leaning off each face's normal, so its offsets are not axial
TILT = np.array([0.31, -0.22, 0.17])
# K3 against its plain version (chip_smoke.LIMITS["tf_alpha"]): expf/logf
# ulps against PyTorch's exp/log
TF_ALPHA_LIMIT = 1e-6
# K8 against its plain version (chip_smoke.BWD_LIMITS["tf_alpha_bwd"]),
# the largest error over the largest value of each cotangent
TF_ALPHA_BWD_LIMIT = 1e-4


def _clip(name):
    c, d = (np.asarray(v, np.float32) for v in CLIPS[name])
    return c, d / np.float32(np.linalg.norm(d))


def _face_plan(face, light_dims):
    lp = PL.FACE_NORMALS[face] + TILT
    lp[PL.face_axis(face)] = PL.FACE_NORMALS[face][PL.face_axis(face)]
    return PL.plan_face_propagation(face, lp, light_dims, 1.0)


def _inputs(device):
    vol = torch.from_numpy(synthetic.ct_like_phantom(VOL, seed=0))
    return vol.to(device), T.tf_ct_bone(device=device)


def _parent_const_shift_trilinear(volume, light_dims, uvw_offset):
    """The parent's constant-shift resample: shifted slices of an
    edge-padded volume, selection matmuls below full resolution."""
    vd = tuple(int(d) for d in volume.shape)
    ld = tuple(int(d) for d in light_dims)
    r = tuple(v // l for v, l in zip(vd, ld))
    off = np.asarray(uvw_offset, np.float32)
    pads = tuple(r[a] + 2 + -(-r[a] * ld[a] // min(ld)) for a in range(3))
    vp = F.pad(volume[None, None],
               (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0]),
               mode="replicate")[0, 0]
    i0, frac = [], []
    for a in range(3):
        c = np.float32(0.5 * r[a] - 0.5) + off[a] * np.float32(vd[a])
        f = np.floor(c)
        frac.append(np.float32(c - f))
        i0.append(int(np.clip(int(f) + pads[a], 0, 2 * pads[a] + r[a] - 2)))
    fx, fy, fz = frac
    one = np.float32(1.0)
    gx, gy, gz = (float(one - f) for f in frac)
    fx, fy, fz = float(fx), float(fy), float(fz)
    if all(v == 1 for v in r):
        def corner(dx, dy, dz):
            return vp[i0[0] + dx:i0[0] + dx + ld[0],
                      i0[1] + dy:i0[1] + dy + ld[1],
                      i0[2] + dz:i0[2] + dz + ld[2]]

        c00 = corner(0, 0, 0) * gz + corner(0, 0, 1) * fz
        c01 = corner(0, 1, 0) * gz + corner(0, 1, 1) * fz
        c10 = corner(1, 0, 0) * gz + corner(1, 0, 1) * fz
        c11 = corner(1, 1, 0) * gz + corner(1, 1, 1) * fz
        c0 = c00 * gy + c01 * fy
        c1 = c10 * gy + c11 * fy
        return c0 * gx + c1 * fx

    def sel(axis, f, g1):
        g = torch.arange(ld[axis], device=vp.device) * r[axis] + i0[axis]
        j = torch.arange(vp.shape[axis], device=vp.device)
        return ((j[None, :] == g[:, None]).float() * g1
                + (j[None, :] == (g + 1)[:, None]).float() * f)

    t = torch.einsum("gx,xyz->gyz", sel(0, fx, gx), vp)
    t = torch.einsum("hy,gyz->ghz", sel(1, fy, gy), t)
    return torch.einsum("iz,ghz->ghi", sel(2, fz, gz), t)


def _parent_occluder(volume, tf_table, windowing_vec4, light_dims,
                     uvw_offset, step_size, clip_center, clip_direction):
    """The parent's `occluder_opacity_volume`: the composition around K3
    on the values (differentiable through `windowed_tf_alpha_vjp`)."""
    dev = volume.device
    res = torch.tensor(light_dims, dtype=torch.float32, device=dev)
    grids = torch.meshgrid(
        *[torch.arange(d, dtype=torch.float32, device=dev)
          for d in light_dims], indexing="ij")
    off = torch.as_tensor(np.asarray(uvw_offset, np.float32), device=dev)
    uvw = (torch.stack(grids, dim=-1) + 0.5) / res + off
    alpha_weight = S.clip_soft_alpha_weight(uvw, clip_center,
                                            clip_direction, res)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    vd = tuple(volume.shape)
    if all(v % l == 0 for v, l in zip(vd, light_dims)):
        value = _parent_const_shift_trilinear(volume, light_dims, uvw_offset)
    else:
        value = S.trilinear_sample(volume, uvw)
    step = float(np.float32(step_size) * np.float32(S.VOLUME_DENSITY))
    opacity = PK3.windowed_tf_alpha_vjp(value, tf_table, windowing_vec4,
                                        step)
    keep = inside & (alpha_weight > 0.0)
    return torch.where(keep, opacity * alpha_weight,
                       torch.zeros_like(opacity))


def _assert_same_bits(got, want, what):
    """``torch.equal``; where they differ, the message says which elements
    differ and by how much, with the thread count and whether this
    thread flushes subnormals (the state that could make two CPU
    evaluations of one expression part)."""
    if torch.equal(got, want):
        return
    diff = got != want
    idx = diff.nonzero()[:8].tolist()
    flushes = bool(torch.tensor([1e-39]) * 1.0 == 0.0)
    raise AssertionError(
        f"{what}: {int(diff.sum())} of {want.numel()} elements differ, max "
        f"abs {float((got - want).abs().max()):.3e}; the first at {idx}: "
        f"got {got[diff][:8].tolist()}, want {want[diff][:8].tolist()} | "
        f"torch threads {torch.get_num_threads()}, subnormals flushed on "
        f"this thread {flushes}")


def _args(vol, tf, win, face, ratio, clip):
    ld = LIGHT[ratio]
    fp = _face_plan(face, ld)
    return (vol, tf, win, ld, fp.uvw_offset, fp.step_size, *_clip(clip))


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("ratio", [1, 2, "uneven"])
@pytest.mark.parametrize("face", range(6))
def test_occluder_plain_matches_parent(face, ratio, clip):
    """Every face class, full and half resolution and a ratio that is not
    an integer, clip planes that cross the volume, miss it and lie along a
    face: the plain version gives the parent composition's bits."""
    vol, tf = _inputs("cpu")
    args = _args(vol, tf, WIN, face, ratio, clip)
    want = _parent_occluder(*args)
    got, values, keep_weight = PL.occluder_opacity_plain(*args, parts=True)
    _assert_same_bits(got, want, "the plain version")
    _assert_same_bits(PL.occluder_opacity(*args), want, "occluder_opacity")
    assert (want > 0).any()
    if clip != "miss":  # the plane cuts voxels off
        assert (keep_weight == 0).any() and (keep_weight == 1).any()
    assert values.shape == keep_weight.shape == want.shape


@pytest.mark.parametrize("ratio", [1, 2, "uneven"])
@pytest.mark.parametrize("face", range(6))
def test_occluder_grads_match_parent(face, ratio):
    """The differentiable unit's value and its cotangents of the volume,
    the TF table and the window against the parent composition's autograd,
    bit for bit, on the CPU (K8's plain version and the resample's
    adjoint)."""
    vol, tf = _inputs("cpu")
    g = torch.from_numpy(np.random.default_rng(face).standard_normal(
        LIGHT[ratio]).astype(np.float32))
    grads = []
    for fn in (PL.occluder_opacity_volume, _parent_occluder):
        leaves = (vol.clone().requires_grad_(), tf.clone().requires_grad_(),
                  torch.tensor(WIN, requires_grad=True))
        out = fn(*_args(*leaves, face, ratio, "cross"))
        (out * g).sum().backward()
        grads.append((out.detach(), *(t.grad for t in leaves)))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    assert grads[0][1].abs().sum() > 0 and grads[0][2][:, 3].abs().sum() > 0


@pytest.mark.parametrize("window", ["list", "tensor"])
def test_occluder_window_forms(window):
    """A window given as host numbers or as a tensor that takes a
    gradient: the same opacity and d TF, and the tensor its d window."""
    vol, tf = _inputs("cpu")
    win = (list(WIN) if window == "list"
           else torch.tensor(WIN, requires_grad=True))
    tf_leaf = tf.clone().requires_grad_()
    out = PL.occluder_opacity_volume(*_args(vol, tf_leaf, win, 3, 1, "cross"))
    out.sum().backward()
    want_tf = tf.clone().requires_grad_()
    want = _parent_occluder(*_args(vol, want_tf, torch.tensor(WIN), 3, 1,
                                   "cross"))
    want.sum().backward()
    assert torch.equal(out, want) and torch.equal(tf_leaf.grad, want_tf.grad)
    if window == "tensor":
        assert win.grad is not None and win.grad[:2].abs().sum() > 0


def test_occluder_skips_parts_without_grad():
    """Without a gradient asked for, the Function keeps nothing and the
    parts are not made; with one, only the inputs that ask get one."""
    vol, tf = _inputs("cpu")
    with mock.patch.object(PL, "occluder_opacity",
                           wraps=PL.occluder_opacity) as spy:
        PL.occluder_opacity_volume(*_args(vol, tf, WIN, 0, 1, "cross"))
        assert spy.call_args.kwargs["parts"] is False
        tf_leaf = tf.clone().requires_grad_()
        out = PL.occluder_opacity_volume(
            *_args(vol, tf_leaf, WIN, 0, 1, "cross"))
        assert spy.call_args.kwargs["parts"] is True
    out.sum().backward()
    assert tf_leaf.grad is not None and vol.grad is None


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _check_against_plain(args, ratio):
    before = PL.occluder_opacity.launches
    got, values, keep_weight = PL.occluder_opacity(*args, parts=True)
    assert PL.occluder_opacity.launches == before + 1
    assert torch.equal(PL.occluder_opacity(*args), got)
    want, want_values, want_kw = PL.occluder_opacity_plain(*args, parts=True)
    torch.cuda.synchronize()
    # the clip weight's distance and norm sum in another order than
    # PyTorch's: two ulps of a distance below 1 times the weight's slope
    weight_limit = S.ONE_OVER_SQRT_3 * max(args[3]) * 2.0 ** -22
    torch.testing.assert_close(keep_weight, want_kw, rtol=0,
                               atol=weight_limit)
    if ratio == 1:
        assert torch.equal(values, want_values)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=TF_ALPHA_LIMIT + weight_limit)
    else:
        # the kernel's lerps against the selection matmuls' fused sums: an
        # ulp of a value, which the TF's slope (up to 256 / width per unit
        # of alpha) carries into the opacity
        torch.testing.assert_close(values, want_values, rtol=0, atol=1e-6)
    # the opacity from the kernel's own values and weights
    step = PL._step(args[5])
    alpha = PK3.windowed_tf_alpha_plain(values, args[1], args[2], step)
    torch.testing.assert_close(got, alpha * keep_weight, rtol=0,
                               atol=TF_ALPHA_LIMIT)
    assert (got > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("ratio", [1, 2])
@pytest.mark.parametrize("face", range(6))
def test_occluder_kernel_matches_plain(cuda, face, ratio, clip):
    vol, tf = _inputs(cuda)
    _check_against_plain(_args(vol, tf, WIN, face, ratio, clip), ratio)


@pytest.mark.cuda
def test_occluder_kernel_matches_plain_chest(cuda):
    """The clip drag's shape: 512x512x384 (a seeded uniform volume),
    full-resolution light, a plane across the volume given as device
    tensors, on the bench light's primary face."""
    dims = (512, 512, 384)
    vol = torch.rand(dims, generator=torch.Generator(cuda).manual_seed(0),
                     device=cuda)
    tf = T.tf_ct_bone(device=cuda)
    fp = _face_plan(4, dims)
    cc, cd = (torch.from_numpy(c).to(cuda) for c in _clip("cross"))
    _check_against_plain((vol, tf, WIN, dims, fp.uvw_offset, fp.step_size,
                          cc, cd), 1)


def _illumination_grads(vol, tf, dims, plans, clip, g):
    params = PP.RenderParams(
        vol.clone().requires_grad_(), tf.clone().requires_grad_(),
        torch.tensor(0.5, device=vol.device, requires_grad=True),
        torch.tensor(0.8, device=vol.device, requires_grad=True),
        torch.tensor([0.9], device=vol.device))
    lv = PP.compute_illumination(params, plans, *clip, dims)
    (lv * g).sum().backward()
    return lv.detach(), [params.volume.grad, params.tf_table.grad,
                         params.window_center.grad, params.window_width.grad]


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1, 2])
def test_occluder_grads_match_parent_on_card(cuda, ratio):
    """d volume, d TF and d window through `compute_illumination` (both
    faces of a light, K4/K7 and K8 on the card) against the parent
    composition's autograd, within K8's limit against its plain version."""
    vol, tf = _inputs(cuda)
    dims = LIGHT[ratio]
    plans = (PP.LightPlan.create((0.3, 0.1, -0.95), dims),)
    clip = _clip("cross")
    g = torch.from_numpy(np.random.default_rng(ratio).standard_normal(
        dims).astype(np.float32)).to(cuda)
    before = PL.occluder_opacity.launches
    got = _illumination_grads(vol, tf, dims, plans, clip, g)
    assert PL.occluder_opacity.launches == before + 2
    with mock.patch.object(PL, "occluder_opacity_volume", _parent_occluder):
        want = _illumination_grads(vol, tf, dims, plans, clip, g)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for a, b in zip(got[1], want[1]):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= TF_ALPHA_BWD_LIMIT, err


@pytest.mark.cuda
def test_occluder_launches_one_a_face(cuda):
    """A full rebuild launches K3's occluder source once a face and K3 on
    values never."""
    vol, tf = _inputs(cuda)
    lights = [((0.3, 0.1, -0.95), 1.0), ((-0.7, 0.6, 0.2), 0.5)]
    faces = sum(len(PP.LightPlan.create(d, VOL).face_plans)
                for d, _ in lights)
    before = (PL.occluder_opacity.launches, PK3.windowed_tf_alpha.launches)
    with torch.no_grad():
        lv = PL.reset_all_lights(vol, tf, WIN, *_clip("cross"), lights, VOL)
    torch.cuda.synchronize()
    assert PL.occluder_opacity.launches == before[0] + faces
    assert PK3.windowed_tf_alpha.launches == before[1]
    assert faces == 4 and float(lv.max()) > 0.1
