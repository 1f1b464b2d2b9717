"""The slab-sharded `Renderer` (``mesh=``, ``global_dims=``): every rank
holds one Z slab of the volume and its chunk of the light volume, and
rank 0 renders the whole frame.

On the CPU a module-scoped fixture runs `_torch_slab_worker.py` once at
world 2 and once at world 4 (gloo, one thread a rank, both at once) on
the benchmark's Richtmyer-Meshkov stand-in at 32x24x32, and the cases
here hold what rank 0 wrote:

- the light volume, the ranks' chunks in rank order, against the one-card
  `Renderer`'s bit for bit, after the first frame's rebuild and after a
  rebuild for a new clip plane and for a new window center (each face's
  light is the one-card scan's: K3's field on a slab is the whole field's
  planes, the ring's carries and the light halo chain the scans);
- the frame against the one-card `Renderer`'s and against the blockwise
  reference (`rmbench/reference/slab_blocks.py`), within 1e-5: the one
  expected difference is the pre-shear, whose planes are the ranks'
  float32 partial sums added in another order than one card's matmuls
  (an ulp or two of each sample);
- cases: the principal axis along X, Y and Z; a Z face whose ring runs
  down Z and one that runs up it; a second face along X and along Y, and
  a light with no Z face; two lights (each light's faces summed into its
  contribution first, the one-card order); a clip plane; early
  termination at 0.95 (the
  scenes' opaque rays end there); jitter on and off;
- no rank's renderer holds a tensor of the whole volume's size; a slab
  of another shape is refused.

The card tests (`-m cuda`, skipped without a card) hold the kernels the
sharded path adds arguments to: K3's occluder source on a Z window of a
held slab against the whole field's planes, K4 in four chunks chained by
carries against one scan of the face, and K1 on a column band of summed
partial planes against the one-card composite's band.

This file imports no JAX: on the machine with the card run it as

    python -m pytest tests/test_torch_slab_renderer.py -q --noconftest
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import _torch_slab_worker as W
from rmbench.reference import frame as RF
from rmbench.reference import scene as RS
from rmbench.reference import slab_blocks as SB
from rmbench.reference.common import tf_table
from rmbench.volumes import rm_mixing
from tbraymarcherplugin_tpu_torch.ops import composite as PC
from tbraymarcherplugin_tpu_torch.ops import light_scan as PK4
from tbraymarcherplugin_tpu_torch.ops import lighting as PL
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
from tbraymarcherplugin_tpu_torch.scene import Camera, ClipPlane, DirLight
from tbraymarcherplugin_tpu_torch.utils.volume_info import (
    WindowingParameters)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)
SPAWN_TIMEOUT = 300
# the frames' limit: the ranks' float32 partial sums of the pre-shear
# against one card's sums, an ulp or two of each plane sample
FRAME_ATOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    """{world: the arrays rank 0 wrote}, both worlds spawned at once."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for world in WORLDS:
            store = os.path.join(tmp, f"store{world}")
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank),
                           WORLD_SIZE=str(world), COORD=f"file://{store}",
                           OMP_NUM_THREADS="1")
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(HERE,
                                                  "_torch_slab_worker.py"),
                     os.path.join(tmp, f"out{world}.npz")],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log.decode()[-3000:]
        return {w: dict(np.load(os.path.join(tmp, f"out{w}.npz")))
                for w in WORLDS}


@pytest.fixture(scope="module")
def one_card():
    """{case: [(frame, light volume) of each step]} of the one-card
    `Renderer` on the whole volume, and the reference's frames."""
    vol = rm_mixing.make(W.DIMS, W.SEED, "cpu")
    table = tf_table("ct_soft_tissue")
    out = {}
    for name, (cam, lights, clipped, jitter) in W.CASES.items():
        r = Renderer(vol, tf_table=table,
                     windowing=WindowingParameters(*W.WINDOW),
                     config=RendererConfig(step_count=W.STEPS,
                                           jitter=jitter), device="cpu")
        for i, (light, intensity) in enumerate(lights):
            r.add_light(f"l{i}", DirLight.create(light, intensity))
        if clipped:
            r.set_clip_plane(ClipPlane.create(*W.CLIP))
        camera = Camera.look_at(np.asarray(cam), np.zeros(3),
                                fov_degrees=35.0)
        steps = []
        for step in range(3):
            if step == 1:
                r.set_clip_plane(ClipPlane.create(*W.CLIP))
            if step == 2:
                r.set_window_center(W.CENTER)
            img = r.render(camera, *W.SIZE)
            steps.append((img.numpy(), r.light_volume.numpy().copy(),
                          _reference(vol, table, name, step)))
        out[name] = steps
    return out


def _reference(vol, table, name, step):
    """The blockwise reference's frame of a case's step."""
    cam, lights, clipped, jitter = W.CASES[name]
    center = W.CENTER if step == 2 else W.WINDOW[0]
    clip = (RS.ClipPlane.create(*W.CLIP) if clipped or step
            else RS.ClipPlane.disabled())
    scene = RF.Scene(volume=vol, table=table,
                     window=(center, W.WINDOW[1], 1.0, 1.0),
                     transform=RS.VolumeTransform.create(),
                     lights=tuple((tuple(d), i) for d, i in lights),
                     clip=clip,
                     width=W.SIZE[0], height=W.SIZE[1], step_count=W.STEPS,
                     jitter=jitter)
    camera = RS.Camera.look_at(cam, (0.0, 0.0, 0.0), fov_degrees=35.0)
    # the blockwise reference rebuilds one light; two take the whole
    # volume's reference rebuild (`reference/frame.py`)
    lv = (SB.illumination(scene) if len(lights) == 1
          else RF.illumination(scene))
    return SB.frame(scene, camera, lv, step).numpy()


CASE_STEPS = [(w, c, s) for w in WORLDS for c in W.CASES for s in range(3)]


@pytest.mark.parametrize("world,case,step", CASE_STEPS)
def test_light_chunks_are_the_one_card_light_bit_for_bit(runs, one_card,
                                                         world, case, step):
    """After the first rebuild (step 0), one for a clip plane (1) and one
    for a window center (2), set on every rank."""
    want = one_card[case][step][1]
    np.testing.assert_array_equal(runs[world][f"{case}_lv{step}"], want)
    assert (want > 0.0).any() and (want < want.max()).any()


@pytest.mark.parametrize("world,case,step", CASE_STEPS)
def test_frame_on_rank_0_is_the_one_card_frame(runs, one_card, world, case,
                                               step):
    got = runs[world][f"{case}_img{step}"]
    img, _, ref = one_card[case][step]
    assert got.shape == (W.SIZE[1], W.SIZE[0], 4)
    np.testing.assert_allclose(got, img, rtol=0.0, atol=FRAME_ATOL)
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=FRAME_ATOL)
    assert img[..., 3].max() > 0.5  # something is drawn


def test_rays_terminate_early(one_card):
    """The scenes' opaque rays reach the 0.95 snap (K1 sets their alpha
    to 1), so early termination is held to the one card's."""
    assert max(float(steps[0][0][..., 3].max())
               for steps in one_card.values()) == 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_no_rank_holds_a_whole_volume(runs, world):
    whole = int(np.prod(W.DIMS))
    assert (runs[world]["largest"] < whole).all()
    assert (runs[world]["largest"] >= whole // world).all()


@pytest.mark.parametrize("world", WORLDS)
def test_a_slab_of_another_shape_is_refused(runs, world):
    assert (runs[world]["refused"] == 1).all()


def test_sharded_renderer_needs_both_keywords():
    with pytest.raises(ValueError, match="both"):
        Renderer(torch.zeros(4, 4, 4), device="cpu", global_dims=(4, 4, 8))


# --- the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("face", range(6))
def test_occluder_kernel_on_a_z_window_is_the_whole_field(cuda, face):
    """K3's occluder source on each rank's slab and halo of four, for its
    light planes and for planes reaching into the halo, against the
    whole field's planes, bit for bit."""
    dims = (96, 80, 64)
    vol = rm_mixing.make(dims, W.SEED, cuda)
    lp = PL.FACE_NORMALS[face] + np.array([0.31, -0.22, 0.17])
    lp[PL.face_axis(face)] = PL.FACE_NORMALS[face][PL.face_axis(face)]
    fp = PL.plan_face_propagation(face, lp, dims, 1.0)
    clip = ClipPlane.create([0.5, 0.45, 0.5], [0.3, 0.8, 0.52])
    args = (tf_table("ct_soft_tissue", cuda), [0.55, 0.7, 1.0, 1.0], dims,
            fp.uvw_offset, fp.step_size, clip.center, clip.direction)
    whole = PL.occluder_opacity(vol, *args)
    halo = 6
    for z0 in range(0, 64, 16):
        h0, h1 = max(z0 - halo, 0), min(z0 + 16 + halo, 64)
        held = vol[:, :, h0:h1].contiguous()
        for a, b in ((z0, z0 + 16), (max(z0 - 4, 0), min(z0 + 20, 64))):
            got = PL.occluder_opacity(
                held, *args, window=PL.ZWindow(dims, h0, a, b))
            assert torch.equal(got, whole[:, :, a:b])


@pytest.mark.cuda
@pytest.mark.parametrize("off", [(-0.33, 3.17), (2.7, -0.4), (0.34, 0.11)])
def test_scan_kernel_chunks_chained_by_carries_are_one_scan(cuda, off):
    """K4 on four chunks of a face, each entered by the last slice of the
    one before, against one scan of the whole face, bit for bit."""
    gen = np.random.default_rng(7)
    op = torch.from_numpy(gen.random((40, 512, 384), dtype=np.float32)
                          * 0.3).to(cuda)
    whole = PK4.propagate_face_scan(op, off[0], off[1], 0.9)
    carry, parts = None, []
    for k0 in range(0, 40, 10):
        part = PK4.propagate_face_scan(op[k0:k0 + 10], off[0], off[1], 0.9,
                                       carry)
        parts.append(part)
        carry = part[-1]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), whole)
    plain = PK4.propagate_face_scan_plain(op[10:20], off[0], off[1], 0.9,
                                          whole[9])
    assert torch.equal(parts[1], plain)


@pytest.mark.cuda
def test_composite_kernel_on_a_band_of_summed_partial_planes(cuda):
    """K1 on rank r's column band of four, on the bands of the four slabs'
    summed partial planes, against the one-card composite's band of the
    same planes (the band's plan counts its columns in the whole grid)."""
    from tbraymarcherplugin_tpu_torch.parallel.shearwarp_sharding import (
        _local_plan)
    from tbraymarcherplugin_tpu_torch.scene import VolumeTransform

    dims = (96, 80, 64)
    vol = rm_mixing.make(dims, W.SEED, cuda)
    lv = torch.rand(dims, generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda)
    cam = Camera.look_at(np.array([0.5, -2.3, 0.6]), np.zeros(3),
                         fov_degrees=35.0)
    plan = PSW.plan_shearwarp(cam, VolumeTransform.create(), dims, dims,
                              320, 200, max_planes=48)
    table = tf_table("ct_soft_tissue", cuda)
    win = [0.55, 0.7, 1.0, 1.0]
    clip = ClipPlane.disabled()
    n, nb = 4, plan.n2 // 4
    parts = [PC.preshear_slab(vol[:, :, r * 16:(r + 1) * 16],
                              lv[:, :, r * 16:(r + 1) * 16], plan, dims,
                              dims, r * 16, r * 16, n, True)
             for r in range(n)]
    Wp = sum(p[0] for p in parts).to(torch.bfloat16)
    Lp = sum(p[1] for p in parts).to(torch.bfloat16)
    rng = (torch.stack([p[2][0] for p in parts]).amin(0),
           torch.stack([p[2][1] for p in parts]).amax(0))
    jitter = torch.rand((plan.n1, plan.n2), device=cuda)
    full = PC.composite(**PC.composite_args(
        plan, Wp.permute(1, 2, 0, 3).reshape(Wp.shape[1], plan.n1, -1),
        Lp.permute(1, 2, 0, 3).reshape(Lp.shape[1], plan.n1, -1), table,
        win, rng, clip.center, clip.direction, 0.95, jitter, None, "lit",
        dims[plan.axes12[0]], dims[plan.axes12[1]]))
    for r in range(n):
        cols = slice(r * nb, (r + 1) * nb)
        band = PC.composite(**PC.composite_args(
            _local_plan(plan, r, nb), Wp[r], Lp[r], table, win, rng,
            clip.center, clip.direction, 0.95, jitter[:, cols], None, "lit",
            dims[plan.axes12[0]], dims[plan.axes12[1]]))
        torch.cuda.synchronize()
        torch.testing.assert_close(band, full[:, :, cols], rtol=0.0,
                                   atol=1e-6)
