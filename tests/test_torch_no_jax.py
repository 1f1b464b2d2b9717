"""The port imports, renders and differentiates a frame with JAX
unavailable: a shear-warp frame, a march frame from inside the volume,
fwd+bwd through the fused and the dense shear-warp branches and the
blocked-march branch, and two `fit` steps with a checkpoint."""

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
             config=RendererConfig(step_count=12))
r.add_light("sun", DirLight.create([0.3, 0.1, -0.95], 1.0))
img = r.render(Camera.look_at([0.1, -2.3, 0.4], 0.0, fov_degrees=40.0), 24, 16)
assert img.shape == (16, 24, 4) and bool(img.isfinite().all())
assert float(img[..., 3].max()) > 0.0
# the camera inside the volume: no shear-warp plan, the frame marches (K9)
img = r.render(Camera.look_at([0.1, -0.3, 0.05], 0.0), 24, 16)
assert r._sw_plan is None and bool(img.isfinite().all())
assert float(img[..., 3].max()) > 0.0

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
assert not any(m == "jax" or m.startswith(("jax.", "tbraymarcherplugin_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_renders_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
