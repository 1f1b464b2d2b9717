"""The port imports, renders and differentiates a frame with JAX
unavailable: a shear-warp frame, a march frame from inside the volume, an
intensity and an octree frame,
fwd+bwd through the fused and the dense shear-warp branches and the
blocked-march branch, two `fit` steps with a checkpoint, an MHD loaded and
rendered to a PNG by the render CLI, and the SDF demo's march."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from tbraymarcherplugin_tpu_torch.ops import synthetic, transfer
from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
from tbraymarcherplugin_tpu_torch.scene import Camera, DirLight

r = Renderer(synthetic.ct_like_phantom((16, 16, 16)),
             tf_table=transfer.tf_ct_bone(),
             config=RendererConfig(step_count=12), device="cpu")
r.add_light("sun", DirLight.create([0.3, 0.1, -0.95], 1.0))
img = r.render(Camera.look_at([0.1, -2.3, 0.4], 0.0, fov_degrees=40.0), 24, 16)
assert img.shape == (16, 24, 4) and bool(img.isfinite().all())
assert float(img[..., 3].max()) > 0.0
# the camera inside the volume: no shear-warp plan, the frame marches (K9)
img = r.render(Camera.look_at([0.1, -0.3, 0.05], 0.0), 24, 16)
assert r._sw_plan is None and bool(img.isfinite().all())
assert float(img[..., 3].max()) > 0.0
# the intensity and octree modes: shear-warp frames through K1's variants
for mode in ("intensity", "octree"):
    r.set_render_mode(mode)
    img = r.render(Camera.look_at([0.1, -2.3, 0.4], 0.0, fov_degrees=40.0),
                   24, 16)
    assert r._sw_plan is not None and bool(img.isfinite().all())
    assert float(img[..., 3].max()) > 0.0
r.set_render_mode("lit")

# the differentiable frames: fwd+bwd through K1-K8's, then K10's, plain
# versions
import torch
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import rays, shearwarp
from tbraymarcherplugin_tpu_torch.scene import ClipPlane, VolumeTransform

dims = (16, 16, 16)
cam = Camera.look_at([0.1, -2.3, 0.4], 0.0, fov_degrees=40.0)
tr = VolumeTransform.create()
params = PP.RenderParams(
    torch.from_numpy(synthetic.ct_like_phantom(dims)).requires_grad_(),
    transfer.tf_ct_bone().requires_grad_(),
    torch.tensor(0.5, requires_grad=True), torch.tensor(0.8, requires_grad=True),
    torch.tensor([1.0], requires_grad=True))
clip = ClipPlane.disabled()
img = PP.render_lit_scene(
    params, rays.setup_rays(cam, tr, 24, 16), clip.center, clip.direction,
    (PP.LightPlan.create([0.3, 0.1, -0.95], dims),), dims,
    march_impl="shearwarp", shearwarp_tf_unit="fused",
    shearwarp_plan=shearwarp.plan_shearwarp(cam, tr, dims, dims, 24, 16,
                                            max_planes=12))
(img ** 2).mean().backward()
leaves = (params.volume, params.tf_table, params.window_center,
          params.window_width, params.light_intensities)
for leaf in leaves:
    assert bool(leaf.grad.isfinite().all()) and bool((leaf.grad != 0).any())
    leaf.grad = None
img = PP.render_lit_scene(
    params, rays.setup_rays(cam, tr, 24, 16), clip.center, clip.direction,
    (PP.LightPlan.create([0.3, 0.1, -0.95], dims),), dims,
    march_impl="shearwarp", shearwarp_tf_unit="pallas",
    shearwarp_plan=shearwarp.plan_shearwarp(cam, tr, dims, dims, 24, 16,
                                            max_planes=12))
(img ** 2).mean().backward()
for leaf in leaves:
    assert bool(leaf.grad.isfinite().all()) and bool((leaf.grad != 0).any())
    leaf.grad = None
img = PP.render_lit_scene(
    params, rays.setup_rays(cam, tr, 24, 16), clip.center, clip.direction,
    (PP.LightPlan.create([0.3, 0.1, -0.95], dims),), dims, step_count=12,
    march_impl="blocked")
(img ** 2).mean().backward()
for leaf in leaves:
    assert bool(leaf.grad.isfinite().all()) and bool((leaf.grad != 0).any())

# two fit steps with a checkpoint after each
import tempfile
from tbraymarcherplugin_tpu_torch.models import fitting
from tbraymarcherplugin_tpu_torch.utils.checkpoint import CheckpointManager

with tempfile.TemporaryDirectory() as ckpt:
    with torch.no_grad():
        target = img.detach() * 0.5
    _, losses = fitting.fit(
        params, rays.setup_rays(cam, tr, 24, 16), target, clip.center,
        clip.direction, (PP.LightPlan.create([0.3, 0.1, -0.95], dims),), dims,
        fitting.FitConfig(steps=2, step_count=12), checkpoint_dir=ckpt)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert CheckpointManager(ckpt).all_steps() == [0, 1]
# from disk: an MHD through the loader and the render CLI to a PNG, then
# the SDF demo's march
import os
from tbraymarcherplugin_tpu_torch.io import load_volume
from tbraymarcherplugin_tpu_torch.ops import sdf_march
from tbraymarcherplugin_tpu_torch.tools import png, render_cli

with tempfile.TemporaryDirectory() as d:
    raw = (synthetic.ct_like_phantom((12, 10, 8)) * 4000).astype("<u2")
    raw.transpose(2, 1, 0).tofile(os.path.join(d, "v.raw"))
    with open(os.path.join(d, "v.mhd"), "w") as f:
        f.write("NDims = 3\nDimSize = 12 10 8\nElementSpacing = 2 2 2\n"
                "ElementType = MET_USHORT\nElementDataFile = v.raw\n")
    loaded = load_volume(os.path.join(d, "v.mhd"))
    assert loaded.data.shape == (12, 10, 8) and loaded.info.is_normalized
    out = os.path.join(d, "v.png")
    assert render_cli.main([os.path.join(d, "v.mhd"), out, "--size",
                            "24x16", "--steps", "12", "--tf", "ct_bone",
                            "--device", "cpu"]) == 0
    assert png.read(out).shape == (16, 24, 4)
u = torch.linspace(0.3, 0.7, 4)
entry = torch.stack(torch.meshgrid(u, torch.ones(1), u, indexing="ij"),
                    -1).reshape(-1, 3)
out = sdf_march.march_mandelbulb_distance(
    entry, torch.tensor([0.0, -1.0, 0.0]).expand_as(entry), max_steps=20)
assert out.shape == (16, 2) and bool(out.isfinite().all())
assert not any(m == "jax" or m.startswith(("jax.", "tbraymarcherplugin_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_renders_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one torch thread: the suite's xdist workers share the cores
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


PARALLEL_SCRIPT = r"""
import sys, tempfile, os
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
import torch.distributed as dist
from tbraymarcherplugin_tpu_torch import parallel
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import rays, synthetic, transfer
from tbraymarcherplugin_tpu_torch.parallel import distributed
from tbraymarcherplugin_tpu_torch.scene import Camera, ClipPlane, VolumeTransform

assert len(parallel.__all__) == 12
with tempfile.TemporaryDirectory() as d:
    distributed.initialize_multihost("file://" + os.path.join(d, "store"),
                                     1, 0, device="cpu")
    mesh = parallel.make_mesh({"rays": 1})
    dims = (12, 12, 12)
    params = PP.RenderParams(
        torch.from_numpy(synthetic.ct_like_phantom(dims)),
        transfer.tf_ct_bone(), torch.tensor(0.5), torch.tensor(0.8),
        torch.tensor([1.0]))
    cam = Camera.look_at([0.1, -2.3, 0.4], 0.0, fov_degrees=40.0)
    clip = ClipPlane.disabled()
    img = parallel.render_lit_sharded(
        mesh, params, rays.setup_rays(cam, VolumeTransform.create(), 12, 8),
        clip.center, clip.direction,
        (PP.LightPlan.create([0.3, 0.1, -0.95], dims),), dims, step_count=12)
    assert img.shape == (8, 12, 4) and bool(img.isfinite().all())
    assert float(img[..., 3].max()) > 0.0
    dist.destroy_process_group()
assert not any(m == "jax" or m.startswith(("jax.", "tbraymarcherplugin_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_parallel_runs_without_jax():
    """`parallel` imports, and a world-1 gloo `render_lit_sharded` renders,
    with JAX unavailable."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
