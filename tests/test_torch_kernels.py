"""The port's CUDA kernels (K1-K11) against their plain PyTorch versions on
the card, on the same inputs.

This file imports no JAX: the machine with the card has none. There, run
it without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Without a CUDA device every test skips.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import composite as PC
from tbraymarcherplugin_tpu_torch.ops import fused_march as PK9
from tbraymarcherplugin_tpu_torch.ops import light_scan as PK4
from tbraymarcherplugin_tpu_torch.ops import lighting as PL
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import shearwarp_grad as PK5
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import tf_alpha as PK3
from tbraymarcherplugin_tpu_torch.ops import tf_rgba as PK10
from tbraymarcherplugin_tpu_torch.ops import transfer as T
from tbraymarcherplugin_tpu_torch.ops import warp as PW
from tbraymarcherplugin_tpu_torch.tools import micro as PK11

WINDOWS = ([0.45, 0.7, 1.0, 1.0], [0.5, 1.2, 0.0, 0.0], [0.8, 0.3, 1.0, 0.0])
CLIP = ([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen(request):
    import zlib

    return np.random.default_rng(zlib.adler32(request.node.nodeid.encode()))


@contextlib.contextmanager
def _plain(*swaps):
    """Run the callers of each (module, kernel name, plain version) through
    the plain version, on the card."""
    with contextlib.ExitStack() as stack:
        for mod, name, fn in swaps:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def _plan(dims, w, h, max_planes=None, pos=(0.1, -2.3, 0.4)):
    cam = PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=40.0)
    return PSW.plan_shearwarp(cam, PS.VolumeTransform.create(), dims, dims,
                              w, h, max_planes=max_planes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jitter", [False, True])
def test_composite_kernel_matches_plain(cuda, gen, dtype, jitter):
    dims = (64, 64, 64)
    plan = _plan(dims, 320, 180, max_planes=60)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)
    lv = torch.from_numpy(gen.random(dims, dtype=np.float32)).to(cuda)
    jit = (torch.from_numpy(gen.random((plan.n1, plan.n2), dtype=np.float32))
           .to(cuda) if jitter else None)
    clip = PS.ClipPlane(*CLIP)
    ops = PC.prepare_composite(
        vol, T.tf_ct_bone(device=cuda), lv, plan, WINDOWS[0], clip.center,
        clip.direction, compute_dtype=dtype, jitter=jit)
    before = PC.composite.launches
    got = PC.composite(**ops)
    assert PC.composite.launches == before + 1
    want = PC.composite_plain(**ops)
    torch.cuda.synchronize()
    assert float(want[3].max()) > 0.5
    # one-ulp differences of expf/logf against PyTorch's exp/log
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=2e-6)


def test_row_lerp_kernel_exact_far_beyond_band(cuda, gen):
    """Index spread ~2000 texels per row (the TPU kernel's band was 254)."""
    rows = torch.from_numpy(gen.random((48, 2048), dtype=np.float32)).to(cuda)
    idx = torch.from_numpy((np.linspace(-40.0, 2088.0, 300)[None, :]
                            + gen.random((12, 300)) * 5.0).astype(np.float32)
                           ).to(cuda)
    before = PW.row_lerp.launches
    got = PW.row_lerp(rows, idx, 4)
    assert PW.row_lerp.launches == before + 1
    want = PW.row_lerp_plain(rows, idx, 4)
    torch.cuda.synchronize()
    assert float((idx.amax(1) - idx.amin(1)).min()) > 2000
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("pos", [(0.1, -2.3, 0.4), (2.1, 0.7, 0.9)])
def test_warp_kernel_matches_plain(cuda, gen, pos):
    plan = _plan((64, 64, 64), 640, 360, pos=pos)
    inter = torch.from_numpy(
        gen.random((4, plan.n1, plan.n2), dtype=np.float32)).to(cuda)
    got = PW.warp_to_screen_fused(inter, plan, 640, 360)
    with _plain((PW, "row_lerp", PW.row_lerp_plain)):
        want = PW.warp_to_screen_fused(inter, plan, 640, 360)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_tf_alpha_kernel_matches_plain(cuda, gen):
    vals = torch.from_numpy(
        gen.random((64, 64, 64), dtype=np.float32) * 1.4 - 0.2).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    for win in WINDOWS:
        before = PK3.windowed_tf_alpha.launches
        got = PK3.windowed_tf_alpha(vals, tf, win, 1.7)
        assert PK3.windowed_tf_alpha.launches == before + 1
        want = PK3.windowed_tf_alpha_plain(vals, tf, win, 1.7)
        torch.cuda.synchronize()
        # one-ulp differences of expf/logf against PyTorch's exp/log
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("off", [(0.37, -1.6), (-10.4, 3.3), (2.0, 0.0)])
def test_scan_kernel_matches_plain(cuda, gen, off):
    op = torch.from_numpy(
        gen.random((40, 96, 72), dtype=np.float32) * 0.3).to(cuda)
    before = PK4.propagate_face_scan.launches
    got = PK4.propagate_face_scan(op, off[0], off[1], 0.9)
    assert PK4.propagate_face_scan.launches == before + 1
    want = PK4.propagate_face_scan_plain(op, off[0], off[1], 0.9)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("light_dims", [(48, 48, 48), (24, 24, 24)])
def test_add_dir_light_kernels_match_plain(cuda, light_dims):
    vol = torch.from_numpy(synthetic.ct_like_phantom((48, 48, 48))).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    clip = PS.ClipPlane(*CLIP)
    args = (torch.zeros(light_dims, device=cuda), vol, tf, WINDOWS[0],
            clip.center, clip.direction, [0.3, 0.1, -0.95], 1.0)
    got = PL.add_dir_light(*args)
    with _plain((PK3, "windowed_tf_alpha", PK3.windowed_tf_alpha_plain),
                (PK4, "propagate_face_scan", PK4.propagate_face_scan_plain)):
        want = PL.add_dir_light(*args)
    torch.cuda.synchronize()
    assert float(want.max()) > 0.3
    # K3's exp/log ulps; a voxel next to the write threshold may flip,
    # which changes it by at most the threshold
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=PL.WRITE_SKIP_THRESHOLD * 1.01)


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("half_res_light", [False, True])
@pytest.mark.parametrize("pos", [(0.1, -0.3, 0.05), (0.1, -2.3, 0.4)])
def test_march_kernel_matches_plain(cuda, gen, compat, half_res_light, pos):
    """K9 from inside the volume and from outside, jittered, with a clip
    plane and the low cutoff, the bone TF."""
    dims = (64, 64, 64)
    ldims = (32, 32, 32) if half_res_light else dims
    cam = PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=60.0)
    rays = PR.setup_rays(cam, PS.VolumeTransform.create(), 320, 180,
                         device=cuda)
    jit = PR.jitter_values(320, 180, 2, device=cuda)
    clip = PS.ClipPlane(*CLIP)
    args = (torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda),
            T.tf_ct_bone(device=cuda),
            torch.from_numpy(gen.random(ldims, dtype=np.float32)).to(cuda),
            rays, torch.tensor([0.5, 0.8, 1.0, 0.0], device=cuda),
            clip.center, clip.direction)
    kw = dict(jitter=jit, step_count=96, compat_final_step=compat)
    before = PK9.march_lit_fused.launches
    got = PK9.march_lit_fused(*args, **kw)
    assert PK9.march_lit_fused.launches == before + 1
    want = PK9.march_lit_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float(want[..., 3].max()) > 0.5
    # one-ulp differences of expf/logf against PyTorch's exp/log, through
    # up to ~170 composited samples
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=2e-5)


ALL_PLAIN = (
    (PC, "composite", PC.composite_plain),
    (PW, "row_lerp", PW.row_lerp_plain),
    (PK3, "windowed_tf_alpha", PK3.windowed_tf_alpha_plain),
    (PK4, "propagate_face_scan", PK4.propagate_face_scan_plain),
    (PK5, "composite_bwd", PK5.composite_bwd_plain),
    (PW, "row_lerp_bwd", PW.row_lerp_bwd_plain),
    (PK4, "propagate_face_scan_bwd", PK4.propagate_face_scan_bwd_plain),
    (PK3, "windowed_tf_alpha_bwd", PK3.windowed_tf_alpha_bwd_plain),
)


def _close(got, want, rtol, atol_frac, name):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * scale,
                               err_msg=name)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_tf_alpha_bwd_kernel_matches_plain(cuda, gen):
    vals = torch.from_numpy(
        gen.random((64, 64, 64), dtype=np.float32) * 1.4 - 0.2).to(cuda)
    g = torch.from_numpy(gen.standard_normal((64, 64, 64)).astype(
        np.float32)).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    for win in WINDOWS:
        w = torch.tensor(win, device=cuda)
        before = PK3.windowed_tf_alpha_bwd.launches
        got = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
        assert PK3.windowed_tf_alpha_bwd.launches == before + 1
        again = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
        want = PK3.windowed_tf_alpha_bwd_plain(vals, tf, w, 1.7, g)
        torch.cuda.synchronize()
        assert _same_bits(got, again)  # fixed-order reductions
        # expf/logf ulps per element; sums in another order
        _close(got[0], want[0], 1e-5, 1e-6, "dval")
        _close(got[1], want[1], 1e-4, 1e-5, "dtf")
        _close(got[2], want[2], 1e-4, 1e-5, "dwin")


@pytest.mark.parametrize("off", [(0.37, -1.6), (-10.4, 3.3), (2.0, 0.0)])
def test_scan_bwd_kernel_matches_plain(cuda, gen, off):
    op = torch.from_numpy(
        gen.random((40, 96, 72), dtype=np.float32) * 0.3).to(cuda)
    g = torch.from_numpy(gen.standard_normal((40, 96, 72)).astype(
        np.float32)).to(cuda)
    alpha = torch.tensor(0.9, device=cuda)
    y = PK4.propagate_face_scan(op, off[0], off[1], alpha)
    before = PK4.propagate_face_scan_bwd.launches
    got = PK4.propagate_face_scan_bwd(g, op, y, off[0], off[1], alpha)
    assert PK4.propagate_face_scan_bwd.launches == before + 1
    want = PK4.propagate_face_scan_bwd_plain(g, op, y, off[0], off[1], alpha)
    torch.cuda.synchronize()
    for a, b in zip(got, want):  # the same operations in the same order
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_row_lerp_bwd_kernel_matches_plain(cuda, gen):
    """Index spread ~2000 texels per row, magnifying rows, both edges."""
    g = torch.from_numpy(gen.standard_normal((48, 3000)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy((np.linspace(-40.0, 2088.0, 3000)[None, :]
                            + gen.random((12, 3000)) * 5.0).astype(np.float32)
                           ).to(cuda)
    before = PW.row_lerp_bwd.launches
    got = PW.row_lerp_bwd(g, idx, 2048, 4)
    assert PW.row_lerp_bwd.launches == before + 1
    again = PW.row_lerp_bwd(g, idx, 2048, 4)
    want = PW.row_lerp_bwd_plain(g, idx, 2048, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want, 1e-5, 1e-6, "d rows")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("win", [WINDOWS[0], [0.3, 1.5, 0.0, 0.0]])
def test_composite_bwd_kernel_matches_plain(cuda, gen, dtype, win):
    dims = (64, 64, 64)
    plan = _plan(dims, 320, 180, max_planes=60)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)
    lv = torch.from_numpy(gen.random(dims, dtype=np.float32)).to(cuda)
    clip = PS.ClipPlane(*CLIP)
    ops = PC.prepare_composite(
        vol, T.tf_ct_bone(device=cuda), lv, plan, win, clip.center,
        clip.direction, compute_dtype=dtype)
    for k in ("jitter", "occ"):
        del ops[k]
    ops["g"] = torch.from_numpy(gen.random((4, plan.n1, plan.n2),
                                           dtype=np.float32)).to(cuda)
    before = PK5.composite_bwd.launches
    got = PK5.composite_bwd(**ops)
    assert PK5.composite_bwd.launches == before + 1
    again = PK5.composite_bwd(**ops)
    want = PK5.composite_bwd_plain(**ops)
    torch.cuda.synchronize()
    assert _same_bits(got, again)  # fixed-order reductions
    assert got[0].dtype == dtype and got[1].dtype == dtype
    assert float(want[2].abs().max()) > 0
    # expf/logf ulps through the reverse recurrences; with bf16 cotangents
    # an ulp of float32 can round to the next bf16 value (2^-8 relative)
    rtol = 1e-4 if dtype == torch.float32 else 8e-3
    for name, a, b in zip(("dW", "dL"), got, want):
        _close(a, b, rtol, 1e-5, name)
    _close(got[2], want[2], 1e-4, 1e-5, "dtf")
    _close(got[3], want[3], 1e-4, 1e-5, "dwin")


def test_render_lit_scene_grads_kernels_match_plain(cuda):
    """The whole fwd+bwd at 32^3 through K1-K8 against the all-plain path
    on the card (float32 planes)."""
    dims = (32, 32, 32)
    cam = PS.Camera.look_at((0.1, -2.3, 0.4), 0.0, fov_degrees=40.0)
    tr = PS.VolumeTransform.create()
    plan = PSW.plan_shearwarp(cam, tr, dims, dims, 160, 90, max_planes=24)
    plans = (PP.LightPlan.create((0.3, 0.1, -0.95), dims),)
    clip = PS.ClipPlane.disabled()
    rays = PR.setup_rays(cam, tr, 160, 90)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)

    def grads():
        params = PP.RenderParams(
            vol.clone().requires_grad_(),
            T.tf_ct_bone(device=cuda).requires_grad_(),
            torch.tensor(0.55, device=cuda, requires_grad=True),
            torch.tensor(0.8, device=cuda, requires_grad=True),
            torch.tensor([1.0], device=cuda, requires_grad=True))
        img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                                  plans, dims, march_impl="shearwarp",
                                  shearwarp_plan=plan,
                                  shearwarp_tf_unit="fused",
                                  shearwarp_dtype=torch.float32)
        (img ** 2).mean().backward()
        return [p.grad for p in (params.volume, params.tf_table,
                                 params.window_center, params.window_width,
                                 params.light_intensities)]

    counters = [getattr(mod, name) for mod, name, _ in ALL_PLAIN]
    before = [fn.launches for fn in counters]
    got = grads()
    assert all(fn.launches > b for fn, b in zip(counters, before))
    with _plain(*ALL_PLAIN):
        want = grads()
    torch.cuda.synchronize()
    for name, a, b in zip(("volume", "tf", "center", "width", "intensity"),
                          got, want):
        assert float(b.abs().max()) > 0, name
        _close(a, b, 1e-3, 1e-4, name)


def _rgba_inputs(gen, cuda, shape=(8, 96, 160)):
    """Values past both cutoffs, a third of them on the bone TF's alpha
    plateau at 0 (the clip's ties), and the dense composite's (n1, n2)
    step field."""
    vals = gen.random(shape, dtype=np.float32) * 1.4 - 0.2
    vals.reshape(-1)[::3] = np.float32(0.24)
    step = 0.5 + gen.random(shape[1:], dtype=np.float32)
    return (torch.from_numpy(vals).to(cuda),
            torch.from_numpy(step).to(cuda))


@pytest.mark.parametrize("win", WINDOWS)
def test_tf_rgba_kernel_matches_plain(cuda, gen, win):
    vals, step = _rgba_inputs(gen, cuda)
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(win, device=cuda)
    for s in (step, step.expand(vals.shape).contiguous(), 0.9):
        before = PK10.windowed_tf_rgba.launches
        got = PK10.windowed_tf_rgba(vals, tf, w, s)
        assert PK10.windowed_tf_rgba.launches == before + 1
        want = PK10.windowed_tf_rgba_plain(vals, tf, w, s)
        torch.cuda.synchronize()
        assert got.shape == vals.shape + (4,)
        # the RGB lerps round as the plain version; alpha meets expf/logf
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("win", WINDOWS)
def test_tf_rgba_bwd_kernel_matches_plain(cuda, gen, win):
    vals, step = _rgba_inputs(gen, cuda)
    g = torch.from_numpy(gen.standard_normal(tuple(vals.shape) + (4,))
                         .astype(np.float32)).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(win, device=cuda)
    for need_step in (True, False):
        before = PK10.windowed_tf_rgba_bwd.launches
        got = PK10.windowed_tf_rgba_bwd(vals, tf, w, step, g, need_step)
        assert PK10.windowed_tf_rgba_bwd.launches == before + 1
        again = PK10.windowed_tf_rgba_bwd(vals, tf, w, step, g, need_step)
        want = PK10.windowed_tf_rgba_bwd_plain(vals, tf, w, step, g,
                                               need_step)
        torch.cuda.synchronize()
        assert _same_bits(got[:3], again[:3])  # fixed-order reductions
        # expf/logf ulps per element; sums in another order
        _close(got[0], want[0], 1e-5, 1e-6, "dval")
        _close(got[1], want[1], 1e-4, 1e-5, "dtf")
        _close(got[2], want[2], 1e-4, 1e-5, "dwin")
        if need_step:
            assert torch.equal(got[3], again[3])
            _close(got[3], want[3], 1e-5, 1e-6, "dstep")
        else:
            assert got[3] is None


def test_dense_composite_kernels_match_plain(cuda):
    """The dense fwd+bwd at 32^3 through K10a/K10b (the "pallas" TF unit)
    against the plain versions on the card."""
    dims = (32, 32, 32)
    cam = PS.Camera.look_at((0.1, -2.3, 0.4), 0.0, fov_degrees=40.0)
    tr = PS.VolumeTransform.create()
    plan = PSW.plan_shearwarp(cam, tr, dims, dims, 160, 90, max_planes=24)
    plans = (PP.LightPlan.create((0.3, 0.1, -0.95), dims),)
    clip = PS.ClipPlane(*CLIP)
    rays = PR.setup_rays(cam, tr, 160, 90)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)

    def run():
        params = PP.RenderParams(
            vol.clone().requires_grad_(),
            T.tf_ct_bone(device=cuda).requires_grad_(),
            torch.tensor(0.55, device=cuda, requires_grad=True),
            torch.tensor(0.8, device=cuda, requires_grad=True),
            torch.tensor([1.0], device=cuda, requires_grad=True))
        img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                                  plans, dims, march_impl="shearwarp",
                                  shearwarp_plan=plan,
                                  shearwarp_tf_unit="pallas")
        (img ** 2).mean().backward()
        return [img.detach()] + [p.grad for p in (
            params.volume, params.tf_table, params.window_center,
            params.window_width, params.light_intensities)]

    fwd, bwd = PK10.windowed_tf_rgba, PK10.windowed_tf_rgba_bwd
    before = (fwd.launches, bwd.launches)
    got = run()
    # 3 blocks of 8 planes: forward, the checkpoint's recompute, backward
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (6, 3)
    with _plain((PK10, "windowed_tf_rgba", PK10.windowed_tf_rgba_plain),
                (PK10, "windowed_tf_rgba_bwd",
                 PK10.windowed_tf_rgba_bwd_plain)):
        want = run()
    torch.cuda.synchronize()
    for name, a, b in zip(("image", "volume", "tf", "center", "width",
                           "intensity"), got, want):
        assert float(b.abs().max()) > 0, name
        _close(a, b, 1e-3, 1e-4, name)


def test_gather_probe_kernel_matches_plain(cuda):
    tab, idx = PK11.probe_inputs(cuda, seed=5)
    before = PK11.gather_probe.launches
    got = PK11.gather_probe(tab, idx)
    assert PK11.gather_probe.launches == before + 1
    want = PK11.gather_probe_plain(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
