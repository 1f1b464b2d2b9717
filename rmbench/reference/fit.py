"""The reference's inverse-rendering step, and the comparison of a fit's
first steps with it.

The step is the program's fit step worked out in plain PyTorch autograd:
the illumination of every light (the scan and the occluder field of
`lighting.py`, without the write threshold, as the differentiable
pipeline builds it), the shear-warp frame without jitter on float32
planes (`shearwarp.py`, the composite recomputed per run of planes in the
backward), the L2 image loss plus the TF smoothness, ``backward()`` and
`torch.optim.Adam` with the clamps of the program's `fit` (TF in [0, 1],
window width at least 1e-3). Leaves: the TF table, the window center and
the window width.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lighting, shearwarp
from .frame import Scene, plan as frame_plan
from .scene import DirLight

LEAVES = ("tf_table", "window_center", "window_width")
CHECKPOINT_PLANES = 16


def _frame(scene: Scene, camera, table, win, stats=None):
    clip = scene.local_clip()
    lights = [(scene.transform.local_light_direction(DirLight.create(d, i)),
               np.float32(i)) for d, i in scene.lights]
    light = lighting.reset_all_lights(
        scene.volume, table, win, clip.center, clip.direction, lights,
        tuple(scene.volume.shape), apply_write_threshold=False)
    p = frame_plan(scene, camera)
    kw = shearwarp.prepare(scene.volume, table, light, p, win, clip.center,
                           clip.direction, None, scene.early_termination,
                           torch.float32)
    inter = shearwarp.composite_plain(**kw, stats=stats,
                                      checkpoint_planes=CHECKPOINT_PLANES)
    return shearwarp.intermediate_to_screen(inter, p, scene.width,
                                            scene.height)


def target_image(scene: Scene, camera) -> torch.Tensor:
    """The frame the fit steers toward: the scene at its own window."""
    return _frame(scene, camera, scene.table, scene.window_tensor())


class Record:
    """What a fit's first steps leave: each step's loss, each leaf's first
    gradient (Adam's first moment after one step over ``1 - beta1``) and
    each leaf's change since the start."""

    def __init__(self, leaves):
        self.start = [t.detach().clone() for t in leaves]
        self.losses, self.grad1, self.change = [], None, None

    def after_step(self, k: int, loss: float, opt, leaves, beta1: float):
        self.losses.append(loss)
        if k == 0:
            self.grad1 = {n: opt.state[t]["exp_avg"].detach().clone()
                          / (1.0 - beta1) for n, t in zip(LEAVES, leaves)}
        self.change = {n: t.detach() - s for n, t, s in
                       zip(LEAVES, leaves, self.start)}


def reference_steps(scene: Scene, camera, target, traffic: dict, steps: int,
                    stats: dict | None = None) -> Record:
    """``steps`` reference steps from the mix's start; ``stats`` receives
    the first step's composite counts."""
    dev = scene.volume.device
    f32 = torch.float32
    table = scene.table.detach().clone().requires_grad_()
    center = torch.tensor(float(traffic["start_center"]), dtype=f32,
                          device=dev).requires_grad_()
    width = torch.tensor(float(scene.window[1]), dtype=f32,
                         device=dev).requires_grad_()
    leaves = (table, center, width)
    opt = torch.optim.Adam(leaves, lr=float(traffic["lr"]),
                           betas=tuple(traffic["betas"]),
                           eps=float(traffic["eps"]))
    one = torch.ones((), dtype=f32, device=dev)
    rec = Record(leaves)
    for k in range(steps):
        opt.zero_grad(set_to_none=True)
        win = torch.stack([center, width, one, one])
        img = _frame(scene, camera, table, win, stats if k == 0 else None)
        loss = torch.mean((img - target) ** 2)
        smooth = float(traffic["smoothness"])
        if smooth:
            loss = loss + smooth * torch.mean(
                torch.square(table[1:] - table[:-1]))
        loss.backward()
        opt.step()
        with torch.no_grad():
            table.clamp_(0.0, 1.0)
            width.clamp_(min=1e-3)
        rec.after_step(k, float(loss.detach()), opt, leaves,
                       float(traffic["betas"][0]))
        del img, loss
    return rec


def compare(prog: Record, ref: Record) -> dict:
    """The compared numbers: ``loss_gap``, the worst step's relative loss
    gap; ``grad_gap`` and ``change_gap``, the worst leaf's gap of norms
    (`check.leaf_gaps`), leaving out leaves whose reference gradient is
    under a thousandth of the median leaf's."""
    from ..check import leaf_gaps

    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog.losses, ref.losses)]
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in
             ref.grad1.items()}
    med = float(np.median(list(norms.values())))
    skip = tuple(n for n, v in norms.items() if v < 1e-3 * med)
    return {"loss_gap": max(losses),
            "grad_gap": leaf_gaps(prog.grad1, ref.grad1, skip),
            "change_gap": leaf_gaps(prog.change, ref.change, skip)}
