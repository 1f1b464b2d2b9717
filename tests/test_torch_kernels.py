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
from tbraymarcherplugin_tpu_torch.ops import octree as PO
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["intensity", "unlit_nearest",
                                     "lit_depth", "intensity_depth"])
def test_composite_variants_match_plain(cuda, gen, dtype, variant):
    """K1's intensity, unlit (on nearest-texel planes) and λ-ceiling
    variants against the plain version, jitter and a clip plane on."""
    dims = (64, 64, 48)
    plan = _plan(dims, 320, 180, max_planes=60)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)
    jit = torch.from_numpy(gen.random((plan.n1, plan.n2),
                                      dtype=np.float32)).to(cuda)
    mode = variant.split("_")[0]
    lv = (torch.from_numpy(gen.random(dims, dtype=np.float32)).to(cuda)
          if mode == "lit" else None)
    lmax = None
    if variant.endswith("depth"):  # a ceiling mid-volume on the left half
        lam = float(plan.lam[len(plan.lam) // 2])
        lmax = torch.full((plan.n1, plan.n2), float("inf"), device=cuda)
        lmax[:, : plan.n2 // 2] = lam + 0.05 * torch.from_numpy(
            gen.standard_normal((plan.n1, plan.n2 // 2)).astype(
                np.float32)).to(cuda)
    clip = PS.ClipPlane(*CLIP)
    ops = PC.prepare_composite(
        vol, T.tf_ct_bone(device=cuda), lv, plan, WINDOWS[0], clip.center,
        clip.direction, compute_dtype=dtype, jitter=jit, depth_lam=lmax,
        mode=mode, sample_nearest=variant == "unlit_nearest")
    name = PC.variant(mode, lmax)
    before = PC.composite.variant_launches[name]
    got = PC.composite(**ops)
    assert PC.composite.variant_launches[name] == before + 1
    stats = {}
    want = PC.composite_plain(**ops, stats=stats)
    torch.cuda.synchronize()
    assert float(want[3].max()) > 0.5
    assert 0 < stats["samples"] < stats["steps"]
    if mode == "intensity":  # the same first hit as the plain version
        np.testing.assert_array_equal(got[3].cpu().numpy(),
                                      want[3].cpu().numpy())
    # one-ulp differences of expf/logf against PyTorch's exp/log, and of
    # the window's division (PyTorch divides by a scalar as a product with
    # its reciprocal on the card)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="lit mode only"):
        PC.composite(**dict(ops, L=ops["W"] if mode != "lit" else None))


@pytest.mark.parametrize("mode", ["intensity", "octree", "lit"])
def test_renderer_mode_frames_match_plain(cuda, mode):
    """A `Renderer` frame of each mode (jitter on; lit with a scene-depth
    map) through K1 and K2 against the same frame through their plain
    versions, both on bf16 planes."""
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig

    vol = torch.from_numpy(synthetic.ct_like_phantom((40, 40, 40))).to(cuda)
    cam = PS.Camera.look_at((0.1, -2.3, 0.4), (0.0, 0.0, 0.0),
                            fov_degrees=40.0)
    depth = None
    if mode == "lit":
        depth = PR.scene_depth_from_plane(
            cam, PS.VolumeTransform.create(), 160, 90, (0.1, 0.0, 0.0),
            (0.3, 0.9, 0.2), device=cuda)

    def frame():
        r = Renderer(vol, tf_table=T.tf_ct_bone(device=cuda),
                     config=RendererConfig(step_count=30, render_mode=mode),
                     device=cuda)
        r.add_light("sun", PS.DirLight.create((0.3, 0.1, -0.95), 1.0))
        return r.render(cam, 160, 90, scene_depth=depth)

    before = PC.composite.launches
    got = frame()
    assert PC.composite.launches == before + 1
    with _plain((PC, "composite", PC.composite_plain),
                (PW, "row_lerp", PW.row_lerp_plain),
                (PK3, "windowed_tf_alpha", PK3.windowed_tf_alpha_plain),
                (PK4, "propagate_face_scan", PK4.propagate_face_scan_plain)):
        want = frame()
    torch.cuda.synchronize()
    assert float(want[..., 3].max()) > 0.5
    # lit: K3's exp/log ulps reach the light volume (chip_smoke.py's
    # frame limit)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4 if mode == "lit" else 2e-6)


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


@pytest.mark.parametrize("q", [1920, 1083, 5])
@pytest.mark.parametrize("groups", [1, 3, 4])
def test_row_lerp_kernel_exact_any_width_and_groups(cuda, gen, q, groups):
    """Q a multiple of 4 (16-byte index loads and stores) or not (scalar
    ones), one to four channel rows per index row; indices past both ends
    and across the whole row: exactly the plain version."""
    rq, n = 37, 1280
    rows = torch.from_numpy(gen.random((groups * rq, n), dtype=np.float32)
                            ).to(cuda)
    idx = torch.from_numpy((gen.random((rq, q)) * (n + 40.0) - 20.0).astype(
        np.float32)).to(cuda)
    got = PW.row_lerp(rows, idx, groups)
    want = PW.row_lerp_plain(rows, idx, groups)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0


def test_row_lerp_kernel_exact_on_an_unaligned_index_view(cuda, gen):
    """An index view one float into its storage takes the scalar loads."""
    rows = torch.from_numpy(gen.random((4 * 50, 700), dtype=np.float32)
                            ).to(cuda)
    flat = torch.from_numpy((gen.random(50 * 400 + 1) * 720.0 - 10.0).astype(
        np.float32)).to(cuda)
    idx = flat[1:].view(50, 400)
    assert idx.data_ptr() % 16
    got = PW.row_lerp(rows, idx, 4)
    want = PW.row_lerp_plain(rows, idx, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_row_lerp_kernel_exact_beyond_65535_rows(cuda, gen):
    """More rows than a grid's second dimension holds (the first design's
    limit): the threads lie flat over (index row, q)."""
    rq, q, n = 70_000, 12, 16
    rows = torch.from_numpy(gen.random((rq, n), dtype=np.float32)).to(cuda)
    idx = torch.from_numpy((gen.random((rq, q)) * 18.0 - 1.0).astype(
        np.float32)).to(cuda)
    got = PW.row_lerp(rows, idx, 1)
    want = PW.row_lerp_plain(rows, idx, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def _device_ops(fn):
    """Device operations of one ``fn()`` call in torch.profiler's trace."""
    import chip_smoke

    return chip_smoke.device_ms(torch, fn, 3)[1]


@pytest.mark.parametrize("shape,off", [
    ((12, 256, 256), (-0.33, 3.17)),  # the bench faces, cut to depth: T = 8
    ((12, 256, 256), (0.37, -1.6)),
    ((20, 96, 72), (-10.4, 3.3)),     # rows shift past many bands
    ((20, 96, 72), (10.4, -3.3)),
    ((1, 40, 40), (0.5, 0.5)),        # K = 1
    ((3, 17, 13), (2.5, -1.25)),
    ((5, 9, 300), (-1.7, 14.2)),      # fewer rows than SMs
    ((6, 512, 512), (3.4, -9.6)),     # 2-4 pixels a thread
    ((4, 1024, 1024), (-2.2, 1.7)),   # 4 pixels a thread, and chunks beyond
    ((2, 2048, 2048), (-10.4, 3.3)),  # 16 rows a block, 8 chunks
    ((2, 2048, 2048), (10.4, -3.3)),
])
def test_scan_kernel_one_launch_per_face(cuda, gen, shape, off):
    """K4 against its plain version, exactly, with alpha as a tensor and
    by value, and as one device operation per call."""
    op = torch.from_numpy(gen.random(shape, dtype=np.float32) * 0.4).to(cuda)
    alpha = torch.tensor(0.8, device=cuda)
    before = PK4.propagate_face_scan.launches
    got = PK4.propagate_face_scan(op, off[0], off[1], alpha)
    by_value = PK4.propagate_face_scan(op, off[0], off[1], 0.8)
    assert PK4.propagate_face_scan.launches == before + 2
    want = PK4.propagate_face_scan_plain(op, off[0], off[1], alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(by_value, want)
    assert _device_ops(
        lambda: PK4.propagate_face_scan(op, off[0], off[1], alpha)) == 1


@pytest.mark.parametrize("slices,staged", [(1, False), (1, True), (2, True),
                                           (4, True), (8, True), (16, True)])
@pytest.mark.parametrize("off", [(-0.33, 3.17), (2.7, -0.4)])
def test_scan_kernel_every_group_size(cuda, gen, off, slices, staged):
    """K4 with T forced, staged or not, gives the plain version's bits and
    the same bits on every launch (a race shows as one launch of several
    with other bits)."""
    op = torch.from_numpy(gen.random((37, 256, 256), dtype=np.float32)
                          * 0.4).to(cuda)
    want = PK4.propagate_face_scan_plain(op, off[0], off[1], 0.9)
    plan = PK4.scan_plan(*op.shape, off[0], *PK4.device_limits(op.device),
                         slices=slices, staged=staged)
    for _ in range(3):
        got = PK4._launch_scan(op, plan, off[0], off[1], 0.9)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


@pytest.mark.parametrize("mip", [1, 3])
@pytest.mark.parametrize("pos", [(0.1, -0.3, 0.05), (0.1, -2.3, 0.4)])
def test_march_kernel_skipping_empty_space_keeps_the_bits(cuda, gen, mip,
                                                          pos):
    """K9 with the renderer's occupancy grid (margin for the lerps'
    rounding) against itself without the grid (the same bits), against its
    plain version with the grid, and two launches against each other."""
    dims = (64, 64, 64)
    cam = PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=60.0)
    rays = PR.setup_rays(cam, PS.VolumeTransform.create(), 320, 180,
                         device=cuda)
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    win = torch.tensor([0.5, 0.8, 1.0, 1.0], device=cuda)
    occ = PO.occupancy_grid(PO.build_octree(vol), win, tf, mip=mip)
    clip = PS.ClipPlane(*CLIP)
    args = (vol, tf,
            torch.from_numpy(gen.random(dims, dtype=np.float32)).to(cuda),
            rays, win, clip.center, clip.direction)
    kw = dict(jitter=PR.jitter_values(320, 180, 1, device=cuda),
              step_count=120)
    got = PK9.march_lit_fused(*args, **kw, occupancy=occ)
    again = PK9.march_lit_fused(*args, **kw, occupancy=occ)
    bare = PK9.march_lit_fused(*args, **kw)
    stats = {}
    want = PK9.march_lit_fused_plain(*args, **kw, occupancy=occ, stats=stats)
    torch.cuda.synchronize()
    assert float(want[..., 3].max()) > 0.5 and stats["empty"] > 0
    assert torch.equal(got, again) and torch.equal(got, bare)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,off", [
    ((8, 128, 128), (0.37, -1.6)),   # a half-resolution face
    ((6, 96, 200), (-10.4, 3.3)),    # rows shift past many bands
    ((6, 96, 200), (12.6, -7.2)),
    ((4, 256, 256), (-0.33, 3.17)),  # the bench face's offsets
    ((3, 17, 13), (2.5, -1.25)),
    ((5, 9, 300), (-1.7, 14.2)),     # fewer rows than SMs
    ((1, 40, 40), (0.5, 0.5)),
    ((3, 512, 512), (5.3, -2.7)),    # 2 pixels a thread
    ((2, 1024, 1024), (-3.2, 8.9)),  # 8 pixels a thread
])
def test_scan_bwd_kernel_one_launch_per_face(cuda, gen, shape, off):
    """K7 against its plain version, exactly, and against itself, on faces
    of other sizes and offsets of both signs."""
    op = torch.from_numpy(gen.random(shape, dtype=np.float32) * 0.4).to(cuda)
    g = torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32)).to(cuda)
    alpha = torch.tensor(0.7, device=cuda)
    y = PK4.propagate_face_scan(op, off[0], off[1], alpha)
    before = PK4.propagate_face_scan_bwd.launches
    got = PK4.propagate_face_scan_bwd(g, op, y, off[0], off[1], alpha)
    again = PK4.propagate_face_scan_bwd(g, op, y, off[0], off[1], alpha)
    assert PK4.propagate_face_scan_bwd.launches == before + 2
    want = PK4.propagate_face_scan_bwd_plain(g, op, y, off[0], off[1], alpha)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    for a, b in zip(got, want):  # the same operations in the same order
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_scan_bwd_kernel_raises_on_a_face_too_large(cuda):
    op = torch.zeros((1, 2048, 2048), device=cuda)
    with pytest.raises(ValueError, match="K7"):
        PK4.propagate_face_scan_bwd(op, op, op, 0.5, 0.5, 1.0)


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


def _alpha_case(case, gen, n):
    """K8's (values, g, TF table, window) of one kind: a field clamped below
    texel 0 (its low cutoff off), or above texel 255 (its high cutoff off);
    every element cut; g all zero; or uniform values. The TF's alpha lies
    in (0.1, 0.9), so every element that is not cut adds."""
    tf = np.zeros((256, 4), np.float32)
    tf[:, 3] = 0.1 + 0.8 * gen.random(256, dtype=np.float32)
    win = [0.5, 0.8, 1.0, 1.0]
    g = gen.standard_normal(n).astype(np.float32)
    if case == "below_texel_0":
        vals, win = gen.random(n, dtype=np.float32) * 0.1, [0.5, 0.8, 0.0, 1.0]
    elif case == "above_texel_255":
        vals, win = 0.95 + gen.random(n, dtype=np.float32) * 0.1, [0.5, 0.8,
                                                                   1.0, 0.0]
    elif case == "all_cut":
        vals = gen.random(n, dtype=np.float32) * 0.09
    else:
        vals = gen.random(n, dtype=np.float32) * 1.4 - 0.2
        if case == "g_zero":
            g = np.zeros(n, np.float32)
    return vals, g, tf, win


@pytest.mark.parametrize("n", [0, 1, 255, 4 * 1024 * 133 + 3, 300_001])
@pytest.mark.parametrize("case", ["below_texel_0", "above_texel_255",
                                  "all_cut", "g_zero", "random"])
def test_tf_alpha_bwd_kernel_on_clamped_cut_and_ragged_fields(cuda, gen, n,
                                                              case):
    """K8 on a field whose every warp sits on texel 0 (or 255), on a field
    the window cuts whole, on a zero cotangent, and on element counts of 0,
    1, 255 and two that are not a multiple of a thread's run of 4 (the
    first more than one pass of a grid of one block per SM): the same bits
    on two launches, within the limits of
    `test_tf_alpha_bwd_kernel_matches_plain`."""
    vals, g, tf, win = (torch.tensor(x, device=cuda)
                        for x in _alpha_case(case, gen, n))
    stats = {}
    want = PK3.windowed_tf_alpha_bwd_plain(vals, tf, win, 1.3, g,
                                           stats=stats)
    if case == "below_texel_0" and n:
        assert stats["hit"] == 1.0 and stats["rounds_max"] == min(n, 32)
    got = PK3.windowed_tf_alpha_bwd(vals, tf, win, 1.3, g)
    again = PK3.windowed_tf_alpha_bwd(vals, tf, win, 1.3, g)
    torch.cuda.synchronize()
    assert got[0].shape == (n,) and got[1].shape == (256, 4)
    assert got[2].shape == (4,)
    assert _same_bits(got, again)  # fixed-order reductions
    if n:
        _close(got[0], want[0], 1e-5, 1e-6, "dval")
    _close(got[1], want[1], 1e-4, 1e-5, "dtf")
    _close(got[2], want[2], 1e-4, 1e-5, "dwin")
    assert not got[1][:, :3].any() and not got[2][2:].any()
    if case in ("all_cut", "g_zero") or n == 0:
        assert not got[0].any() and not got[1].any() and not got[2].any()


def test_tf_alpha_bwd_kernel_on_unaligned_views(cuda, gen):
    """values and g one float into their storage (not on 16 bytes): the
    scalar loads give the bits of aligned copies."""
    n = 64 * 64 * 64
    flat = torch.from_numpy(gen.random(n + 1, dtype=np.float32) * 1.4 - 0.2
                            ).to(cuda)
    gflat = torch.from_numpy(gen.standard_normal(n + 1).astype(np.float32)
                             ).to(cuda)
    vals, g = flat[1:].view(64, 64, 64), gflat[1:].view(64, 64, 64)
    assert vals.data_ptr() % 16 and g.data_ptr() % 16
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(WINDOWS[0], device=cuda)
    got = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
    want = PK3.windowed_tf_alpha_bwd(vals.clone(), tf, w, 1.7, g.clone())
    torch.cuda.synchronize()
    assert _same_bits(got, want)


def test_tf_alpha_bwd_kernel_is_one_device_operation(cuda, gen):
    """One call is one kernel (d TF and d window written by its last
    block); calls on one stream, each after the counter went back to 0,
    give the same bits, on the default stream and on another."""
    vals = torch.from_numpy(
        gen.random((64, 96, 80), dtype=np.float32) * 1.4 - 0.2).to(cuda)
    g = torch.from_numpy(gen.standard_normal((64, 96, 80)).astype(
        np.float32)).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(WINDOWS[0], device=cuda)
    assert _device_ops(lambda: PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7,
                                                         g)) == 1
    first = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
    runs = [PK3.windowed_tf_alpha_bwd(vals[: 64 - k], tf, w, 1.7, g[: 64 - k])
            for k in range(4)]  # other grids in between
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        on_side = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
    side.synchronize()
    last = PK3.windowed_tf_alpha_bwd(vals, tf, w, 1.7, g)
    torch.cuda.synchronize()
    assert _same_bits(first, runs[0]) and _same_bits(first, last)
    assert _same_bits(first, on_side)
    key = (cuda.index or 0, PK3._kernels.stream_of(vals))
    assert int(PK3._kernels._DONE_COUNTERS[key]) == 0


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


def _index_rows(gen, case, rq, q, n):
    """(rq, q) index rows of one kind: a monotone magnifying row (1.5 q a
    texel, ends clamped), the same reversed (a mirrored view), one
    constant texel (32 lanes on one tap), random texels, and a row that
    rises and falls within each chunk of 32 q."""
    if case == "constant":
        return np.full((rq, q), n * 0.41 + 0.3)
    if case == "random":
        return gen.random((rq, q)) * (n + 20.0) - 10.0
    if case == "zigzag":
        return (np.abs(np.arange(q) % 32 - 15.5)[None, :] * 3.0
                + gen.random((rq, 1)) * (n - 60))
    ramp = (np.linspace(-3.0, q / 1.5 - 3.0, q)[None, :]
            + gen.random((rq, 1)) * (n - q / 1.5))
    return ramp[:, ::-1] if case == "reversed" else ramp


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("case", ["magnify", "reversed", "constant",
                                  "random", "zigzag"])
def test_row_lerp_bwd_kernel_on_index_kinds(cuda, gen, case, groups):
    """K6 on each kind of index row (its runs of equal taps by shuffles,
    or its ordered rounds): the same bits on every launch, within 1e-5 of
    the plain version's largest value."""
    rq, q, n = 24, 1000, 1280
    idx = torch.from_numpy(np.ascontiguousarray(
        _index_rows(gen, case, rq, q, n), np.float32)).to(cuda)
    g = torch.from_numpy(gen.standard_normal((groups * rq, q)).astype(
        np.float32)).to(cuda)
    got = PW.row_lerp_bwd(g, idx, n, groups)
    again = PW.row_lerp_bwd(g, idx, n, groups)
    want = PW.row_lerp_bwd_plain(g, idx, n, groups)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # BWD_LIMITS["row_lerp_bwd"] of chip_smoke.py: the sums run in another
    # order than scatter_add's
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("groups", [4, 2, 3])
@pytest.mark.parametrize("case", ["magnify", "reversed", "zigzag"])
def test_row_lerp_bwd_kernel_on_short_rows(cuda, gen, case, groups):
    """Rows of 300 texels (8 warps a block) in 4, 2 and 3 channel groups:
    the same bits on every launch, within 1e-5."""
    rq, q, n = 40, 450, 300
    idx = torch.from_numpy(np.ascontiguousarray(
        _index_rows(gen, case, rq, q, n), np.float32)).to(cuda)
    g = torch.from_numpy(gen.standard_normal((groups * rq, q)).astype(
        np.float32)).to(cuda)
    got = PW.row_lerp_bwd(g, idx, n, groups)
    again = PW.row_lerp_bwd(g, idx, n, groups)
    want = PW.row_lerp_bwd_plain(g, idx, n, groups)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_row_lerp_bwd_kernel_at_the_largest_rows(cuda, gen):
    """N at the wrapper's largest (4 rows of N floats fill a block's shared
    memory; one warp a block), four channel groups, a magnifying row."""
    n = PW._MAX_BWD_SMEM // 16
    rq, q = 6, 9000
    idx = torch.from_numpy(np.ascontiguousarray(
        _index_rows(gen, "magnify", rq, q, n), np.float32)).to(cuda)
    g = torch.from_numpy(gen.standard_normal((4 * rq, q)).astype(
        np.float32)).to(cuda)
    got = PW.row_lerp_bwd(g, idx, n, 4)
    again = PW.row_lerp_bwd(g, idx, n, 4)
    want = PW.row_lerp_bwd_plain(g, idx, n, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # BWD_LIMITS["row_lerp_bwd"] of chip_smoke.py: the sums run in another
    # order than scatter_add's
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):
        PW.row_lerp_bwd(g[:, :10], idx[:, :10], n + 1, 4)


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


def _ragged_ops(cuda, gen, dtype, mode="lit", jitter=True, win=WINDOWS[0],
                vol=None, align=1, size=(350, 190), margin=(9, 45)):
    """K1's inputs on a plan with ragged tile edges (``align=1``: n1 and n2
    fit the footprint, n2 not a multiple of the 128-pixel tile), grown by
    ``margin`` rows and columns that lie wholly outside the volume's
    footprint."""
    import dataclasses

    dims = (40, 48, 36)
    plan = PSW.plan_shearwarp(
        PS.Camera.look_at((1.7, -1.9, 0.6), (0.0, 0.0, 0.0),
                          fov_degrees=55.0),
        PS.VolumeTransform.create(), dims, dims, *size, align=align,
        max_planes=50)
    plan = dataclasses.replace(plan, n1=plan.n1 + margin[0],
                               n2=plan.n2 + margin[1])
    vol = torch.from_numpy(synthetic.ct_like_phantom(dims)).to(cuda) \
        if vol is None else vol(dims).to(cuda)
    lv = (torch.from_numpy(gen.random(dims, dtype=np.float32)).to(cuda)
          if mode == "lit" else None)
    jit = (torch.from_numpy(gen.random((plan.n1, plan.n2), dtype=np.float32))
           .to(cuda) if jitter else None)
    clip = PS.ClipPlane(*CLIP)
    ops = PC.prepare_composite(
        vol, T.tf_ct_bone(device=cuda), lv, plan, win, clip.center,
        clip.direction, compute_dtype=dtype, jitter=jit, mode=mode,
        sample_nearest=mode == "unlit")
    return plan, dims, ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["lit", "lit_nojitter", "unlit",
                                     "intensity", "lit_depth", "opaque"])
def test_composite_tiles_on_ragged_and_empty_tiles(cuda, gen, dtype,
                                                   variant):
    """K1, each variant, against its plain version on a plan whose tiles
    are ragged (n2 % 128 != 0, and n2 % 4 != 0 for the element-wise
    loads) and where some tiles lie wholly outside the footprint (an empty
    interval); with an opaque constant volume ("opaque") every pixel
    terminates at its first sample, so whole tiles stop in their first
    chunk. Two launches give the same bits."""
    opaque = variant == "opaque"
    mode = "lit" if opaque else variant.split("_")[0]
    plan, dims, ops = _ragged_ops(
        cuda, gen, dtype, mode, jitter=variant != "lit_nojitter",
        win=[0.0, 0.1, 0.0, 0.0] if opaque else WINDOWS[0],
        vol=(lambda d: torch.full(d, 0.6)) if opaque else None)
    assert plan.n2 % 128 != 0 and plan.n2 % 4 != 0
    bounds = PC.tile_plane_bounds(
        ops["pa"], plan.n1, plan.n2, ops["d1"], ops["d2"], plan.k,
        jitter=ops["jitter"] is not None)
    assert (bounds[..., 1] <= bounds[..., 0]).any()  # a tile outside
    if variant == "lit_depth":
        lam = float(plan.lam[len(plan.lam) // 2])
        lmax = torch.full((plan.n1, plan.n2), float("inf"), device=cuda)
        lmax[:, : plan.n2 // 2] = lam + 0.05 * torch.from_numpy(
            gen.standard_normal((plan.n1, plan.n2 // 2)).astype(
                np.float32)).to(cuda)
        ops["depth_lam"] = lmax
    got = PC.composite(**ops)
    again = PC.composite(**ops)
    want = PC.composite_plain(**ops)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float(want[3].max()) > 0.5
    if opaque:  # tiles (rows of 128) whose every hit snapped at once
        n = plan.n2 // 128 * 128
        a = want[3][:, :n].reshape(plan.n1, -1, 128)
        done = ((a > 0).sum(dim=2) >= 64) & ((a > 0) <= (a == 1.0)).all(dim=2)
        assert bool(done.any())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=2e-6)


def _bwd_ops(cuda, gen, ops):
    ops = dict(ops)
    for k in ("jitter", "occ"):
        del ops[k]
    n1, n2 = ops["e1"].shape
    ops["g"] = torch.from_numpy(gen.random((4, n1, n2),
                                           dtype=np.float32)).to(cuda)
    return ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_texel", "ragged"])
def test_composite_bwd_kernel_on_one_texel_and_ragged_tiles(cuda, gen, dtype,
                                                            case):
    """K5 against its plain version where every sample of a warp lies on
    one texel (a constant volume: the histogram adds' worst case), and on
    a plan whose n2 is not a multiple of the tile (nor of 4); the same
    bits on two launches."""
    const = (lambda d: torch.full(d, 0.6)) if case == "one_texel" else None
    _, _, ops = _ragged_ops(cuda, gen, dtype, jitter=False, vol=const,
                            align=1 if case == "ragged" else 128,
                            margin=(0, 0), win=[0.45, 0.7, 0.0, 0.0])
    ops = _bwd_ops(cuda, gen, ops)
    n2 = ops["e1"].shape[1]
    assert (n2 % 128 != 0) == (case == "ragged")
    got = PK5.composite_bwd(**ops)
    again = PK5.composite_bwd(**ops)
    stats = {}
    want = PK5.composite_bwd_plain(**ops, stats=stats)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    assert float(want[2].abs().max()) > 0
    if case == "one_texel":
        assert stats["rounds_max"] == 32
    rtol = 1e-4 if dtype == torch.float32 else 8e-3
    for name, a, b in zip(("dW", "dL"), got, want):
        _close(a, b, rtol, 1e-5, name)
    _close(got[2], want[2], 1e-4, 1e-5, "dtf")
    _close(got[3], want[3], 1e-4, 1e-5, "dwin")


def test_composite_bwd_kernel_keeps_no_transmittance_scratch(cuda, gen):
    """A K5 call allocates its outputs, an alpha checkpoint per 8 planes
    and a row of partials per block: less than half of one float32
    (k_real, n1, n2) transmittance array, which the first design kept."""
    plan, _, ops = _ragged_ops(cuda, gen, torch.bfloat16, jitter=False,
                               align=8, size=(640, 360), margin=(0, 0))
    ops = _bwd_ops(cuda, gen, ops)
    PK5.composite_bwd(**ops)  # built, grid asked, bounds cached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dW, dL, _, _ = PK5.composite_bwd(**ops)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - before
             - dW.nbytes - dL.nbytes)
    t_bytes = 4 * plan.k * plan.n1 * plan.n2
    assert extra < t_bytes / 2, (extra, t_bytes)


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


def _clustered_values(case, gen, shape):
    """K10b's values where the histogram adds cluster as on the dense path
    (window (0.45, 0.7), cutoffs on): every element on one texel, runs of
    2-64 equal values along the rows, a smooth ramp across the window, a
    block all below the lower cutoff, or independent uniform values."""
    n = int(np.prod(shape))
    if case == "one_texel":
        vals = np.full(n, 0.6, np.float32)
    elif case == "runs":
        lengths = gen.integers(2, 65, n)
        vals = np.repeat(gen.random(n, dtype=np.float32) * 1.4 - 0.2,
                         lengths)[:n]
    elif case == "ramp":
        vals = np.broadcast_to(np.linspace(0.05, 0.85, shape[-1],
                                           dtype=np.float32), shape)
    elif case == "all_cut":
        vals = gen.random(n, dtype=np.float32) * 0.09
    else:
        vals = gen.random(n, dtype=np.float32) * 1.4 - 0.2
    return np.ascontiguousarray(vals, np.float32).reshape(shape)


@pytest.mark.parametrize("shape", [(8, 96, 160), (3, 37, 41)])
@pytest.mark.parametrize("case", ["one_texel", "runs", "ramp", "all_cut",
                                  "random"])
def test_tf_rgba_bwd_kernel_on_clustered_texels(cuda, gen, shape, case):
    """K10b where the old one-element-per-lane design serialised (a whole
    warp on one texel, long runs, a ramp), a block the window cuts whole,
    and random values; the (n1, n2) step field of the dense path, its
    length a multiple of 4 or not, and an element count that is not a
    multiple of a thread's run of 4 (the second shape)."""
    vals = torch.from_numpy(_clustered_values(case, gen, shape)).to(cuda)
    step = torch.from_numpy(0.5 + gen.random(shape[1:], dtype=np.float32)
                            ).to(cuda)
    g = torch.from_numpy(gen.standard_normal(shape + (4,)).astype(
        np.float32)).to(cuda)
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(WINDOWS[0], device=cuda)
    stats = {}
    PK10.windowed_tf_rgba_bwd_plain(vals, tf, w, step, g, stats=stats)
    if case == "one_texel":
        assert stats["hit"] == 1.0 and stats["rounds_max"] == 32
    if case == "all_cut":
        assert stats["hit"] == 0.0
    for need_step in (True, False):
        before = PK10.windowed_tf_rgba_bwd.launches
        got = PK10.windowed_tf_rgba_bwd(vals, tf, w, step, g, need_step)
        assert PK10.windowed_tf_rgba_bwd.launches == before + 1
        assert len(got) == 4 and got[1].shape == (256, 4)
        assert got[2].shape == (4,) and got[0].shape == shape
        again = PK10.windowed_tf_rgba_bwd(vals, tf, w, step, g, need_step)
        want = PK10.windowed_tf_rgba_bwd_plain(vals, tf, w, step, g,
                                               need_step)
        torch.cuda.synchronize()
        assert _same_bits(got[:3], again[:3])  # fixed-order reductions
        # expf/logf ulps per element; sums in another order
        _close(got[0], want[0], 1e-5, 1e-6, "dval")
        _close(got[1], want[1], 1e-4, 1e-5, "dtf")
        _close(got[2], want[2], 1e-4, 1e-5, "dwin")
        if case == "all_cut":
            assert not got[1].any() and not got[2].any()
        if need_step:
            assert torch.equal(got[3], again[3])
            _close(got[3], want[3], 1e-5, 1e-6, "dstep")
        else:
            assert got[3] is None


def test_tf_rgba_bwd_kernel_on_unaligned_views(cuda, gen):
    """Inputs whose data does not start on 16 bytes (views one element into
    their storage) give the same cotangents as aligned copies."""
    shape = (4, 40, 52)
    n = int(np.prod(shape))
    flat = torch.from_numpy(_clustered_values("runs", gen, (n + 1,))).to(cuda)
    gflat = torch.from_numpy(gen.standard_normal(4 * n + 4).astype(
        np.float32)).to(cuda)
    vals = flat[1:].view(shape)
    g = gflat[1:4 * n + 1].view(shape + (4,))
    assert vals.data_ptr() % 16 and g.data_ptr() % 16
    tf = T.tf_ct_bone(device=cuda)
    w = torch.tensor(WINDOWS[0], device=cuda)
    got = PK10.windowed_tf_rgba_bwd(vals, tf, w, 0.9, g)
    want = PK10.windowed_tf_rgba_bwd(vals.clone(), tf, w, 0.9, g.clone())
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("n, offset", [(1, 0), (7, 0), (4099, 0),
                                       (256 * 8 * 3 + 5, 0), (4099, 1),
                                       (1000003, 0), (1000003, 3)])
def test_gather_probe_kernel_ragged_and_clamped(cuda, gen, n, offset):
    """K11 on lengths that are no multiple of its 16-byte vectors or of its
    block, on index arrays that do not start on 16 bytes, and on indices
    outside the table, which it clamps to the table's ends."""
    tab = torch.from_numpy(gen.standard_normal(PK11.TABLE).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(gen.integers(-5000, PK11.TABLE + 5000, n + offset,
                                        dtype=np.int32)).to(cuda)[offset:]
    before = PK11.gather_probe.launches
    got = PK11.gather_probe(tab, idx)
    assert PK11.gather_probe.launches == before + 1
    want = tab[idx.long().clamp(0, PK11.TABLE - 1)]
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.equal(got, want)
