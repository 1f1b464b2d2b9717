"""One rank of the port's parallel paths (`tbraymarcherplugin_tpu_torch/
parallel/`) on the CPU over gloo, for tests/test_torch_parallel.py. It
imports no JAX.

    RANK=r WORLD_SIZE=n COORD=file:///tmp/store \
        python tests/_torch_parallel_worker.py inputs.npz out.npz

(``COORD``: a store URL, or ``host:port`` of a TCP store on rank 0.)

The scenes' arrays (volumes, TFs, rays, targets) come from ``inputs.npz``,
written by the test module from the JAX package's generators; the cameras,
lights and plan settings are the constants below, which both sides use.
Each world size runs its share of the jobs (``JOBS``); rank 0 writes the
results to ``out.npz`` (the v2 illumination's chunks gathered first).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_sharding.py's scenes
CAM_A = (0.3, -2.4, 0.5)  # _scene(), the ring's +Z test and the train steps
CAM_PAD = (0.0, -2.5, 0.0)  # 13x7 padding
CAM_DOWN = (0.1, 0.3, 2.4)  # the ring's -Z test: every ray points down Z
LIGHT_A = (0.2, 0.1, -0.97)
LIGHT_B = (-0.9, 0.3, 0.3)
DIMS = (16, 16, 16)
# test_sharded_shearwarp_matches_single_device
SW_CAM, SW_FOV, SW_WIN, SW_SIZE = (0.15, -2.3, 0.35), 35.0, \
    (0.5, 0.9, 1.0, 1.0), (64, 48)
# test_sharded_diff_shearwarp_grads_match_single_device
D_CAM, D_FOV, D_WIN, D_SIZE = (0.2, -2.3, 0.4), 40.0, \
    (0.45, 0.8, 1.0, 1.0), (48, 32)
# test_sharded_illumination_v2_nonuniform_light_dims
V2_CASES = (((32, 32, 32), (16, 16, 16)), ((32, 16, 16), (32, 16, 16)))
WIN_A = (0.5, 1.0, 1.0, 1.0)
NO_CLIP = ((0.0, 0.0, -1e6), (0.0, 0.0, 1.0))


def _t(x):
    import torch

    return torch.from_numpy(np.array(x, np.float32))


def _rays(inp, name):
    from tbraymarcherplugin_tpu_torch.ops.rays import RayBatch

    return RayBatch(*(_t(inp[f"{name}_{k}"]) for k in ("entry", "dir",
                                                       "thick")))


def _params(vol, tf, intensities=(1.0,), center=0.5, width=1.0):
    import torch

    from tbraymarcherplugin_tpu_torch.models.pipeline import RenderParams

    return RenderParams(_t(vol), _t(tf), torch.tensor(center),
                        torch.tensor(width), _t(intensities))


def _plans(dirs, dims):
    from tbraymarcherplugin_tpu_torch.models.pipeline import LightPlan

    return tuple(LightPlan.create(d, dims) for d in dirs)


def _sw_plan(cam, fov, size, **kw):
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.scene import Camera, VolumeTransform

    camera = Camera.look_at(cam, (0.0, 0.0, 0.0), fov_degrees=fov)
    return SW.plan_shearwarp(camera, VolumeTransform.create(), DIMS, DIMS,
                             *size, **kw)


def _np(x):
    return x.detach().numpy()


def ray_jobs(inp, world, exact):
    """render_lit_sharded on scene A (12x12, 24 steps) and on the 13x7
    padding case (16 steps); at world 8 also on a rays 4 x slab 2 mesh."""
    from tbraymarcherplugin_tpu_torch.models.pipeline import render_lit_scene
    from tbraymarcherplugin_tpu_torch.parallel import make_mesh
    from tbraymarcherplugin_tpu_torch.parallel import render_lit_sharded

    params, plans = _params(inp["a_vol"], inp["ramp_tf"]), _plans(
        [LIGHT_A], DIMS)
    out = {}
    cases = (("ray", "a", 24), ("pad", "pad", 16))
    mesh = make_mesh({"rays": world})
    for key, rays, steps in cases:
        out[key] = _np(render_lit_sharded(mesh, params, _rays(inp, rays),
                                          *NO_CLIP, plans, DIMS,
                                          step_count=steps))
        if exact:
            out[key + "_single"] = _np(render_lit_scene(
                params, _rays(inp, rays), *NO_CLIP, plans, DIMS,
                step_count=steps))
    if world == 8:
        mesh2 = make_mesh({"rays": 4, "slab": 2})
        out["mesh2d"] = _np(render_lit_sharded(mesh2, params, _rays(inp, "a"),
                                               *NO_CLIP, plans, DIMS,
                                               step_count=16))
    return out


def shearwarp_jobs(inp, world, exact):
    """shearwarp_lit_sharded at the 64x48 scene (JAX's block size 16; the
    world-1 comparison uses 16 on both sides)."""
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.parallel import make_mesh
    from tbraymarcherplugin_tpu_torch.parallel import shearwarp_lit_sharded

    plan = _sw_plan(SW_CAM, SW_FOV, SW_SIZE, max_n=128, align=8)
    args = (_t(inp["sw_vol"]), _t(inp["bone_tf"]), _t(np.ones(DIMS)), plan,
            _t(SW_WIN), *NO_CLIP, *SW_SIZE)
    out = {"sw": _np(shearwarp_lit_sharded(make_mesh({"rays": world}),
                                           *args))}
    if exact:
        out["sw_single"] = _np(SW.shearwarp_lit(*args, block_size=16))
    return out


def diff_jobs(inp, world, exact):
    """shearwarp_lit_sharded_diff at the 48x32 scene (align 256): the
    frame, the loss and (dvolume, dtf, dwindow); at world 1 also the
    single-device fused path's."""
    import torch

    from tbraymarcherplugin_tpu_torch.ops.shearwarp_grad import (
        shearwarp_intermediate_fused_diff,
    )
    from tbraymarcherplugin_tpu_torch.ops.warp import warp_to_screen_fused
    from tbraymarcherplugin_tpu_torch.parallel import make_mesh
    from tbraymarcherplugin_tpu_torch.parallel import shearwarp_lit_sharded_diff

    plan = _sw_plan(D_CAM, D_FOV, D_SIZE, max_n=256, align=256)
    vol, tf, win = _t(inp["d_vol"]), _t(inp["bone_tf"]), _t(D_WIN)
    lv = torch.full(DIMS, 0.7)
    target = _t(inp["d_target"])
    mesh = make_mesh({"rays": world})
    args = (vol, tf, lv, plan, win, *NO_CLIP, *D_SIZE)
    out = {"diff_img": _np(shearwarp_lit_sharded_diff(mesh, *args))}
    loss, grads = shearwarp_lit_sharded_diff(mesh, *args, target=target)
    out["diff_loss"] = _np(loss)
    for name, g in zip(("dvol", "dtf", "dwin"), grads):
        out["diff_" + name] = _np(g)
    if exact:
        leaves = [x.clone().requires_grad_() for x in (vol, tf, win)]
        img = warp_to_screen_fused(shearwarp_intermediate_fused_diff(
            leaves[0], leaves[1], lv, plan, leaves[2], *NO_CLIP), plan,
            *D_SIZE)
        loss1 = ((img - target) ** 2).sum()
        loss1.backward()
        out["diff_single_img"] = _np(img)
        out["diff_single_loss"] = _np(loss1)
        for name, x in zip(("dvol", "dtf", "dwin"), leaves):
            out["diff_single_" + name] = _np(x.grad)
    return out


def train_jobs(inp, world, exact):
    """make_sharded_train_step: two Adam steps on the 8^3 scene of
    tests/test_multiprocess.py (bulk all-reduce; at world 1 the overlapped
    one too)."""
    import torch

    from tbraymarcherplugin_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, pad_rays_for_mesh,
    )

    mesh = make_mesh({"rays": world})
    flat, _ = pad_rays_for_mesh(_rays(inp, "t"), world)
    target = torch.zeros(flat.thickness.shape + (4,))
    out = {}
    for mode in (False, True) if exact else (False,):
        step, make_opt = make_sharded_train_step(
            mesh, lambda img, tgt: ((img - tgt) ** 2).sum(), *NO_CLIP,
            _plans([LIGHT_A], (8, 8, 8)), (8, 8, 8), step_count=8,
            overlap_allreduce=mode)
        params = _params(inp["t_vol"], inp["ramp_tf"])
        leaves = [x.requires_grad_() for x in vars(params).values()]
        opt = make_opt(leaves)
        key = "train_ov" if mode else "train"
        out[key + "_loss"] = _np(step(params, opt, flat, target))
        out[key + "_tf"] = _np(params.tf_table)
        out[key + "_wc"] = _np(params.window_center)
        out[key + "_loss2"] = _np(step(params, opt, flat, target))
        out[key + "_vol2"] = _np(params.volume)
    return out


def overlap_jobs(inp, world, exact):
    """One SGD(1e-2) step of scene A (8 steps, zero target) in bulk and in
    overlap mode (tests/test_sharding.py::test_overlapped_allreduce_grads_
    match)."""
    import torch

    from tbraymarcherplugin_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, pad_rays_for_mesh,
    )

    mesh = make_mesh({"rays": world})
    flat, _ = pad_rays_for_mesh(_rays(inp, "a"), world)
    target = torch.zeros(flat.thickness.shape + (4,))
    out = {}
    for mode in (False, True):
        step, make_opt = make_sharded_train_step(
            mesh, lambda img, tgt: ((img - tgt) ** 2).sum(), *NO_CLIP,
            _plans([LIGHT_A], DIMS), DIMS, step_count=8,
            optimizer=lambda p: torch.optim.SGD(p, lr=1e-2),
            overlap_allreduce=mode)
        params = _params(inp["a_vol"], inp["ramp_tf"])
        opt = make_opt([x.requires_grad_() for x in vars(params).values()])
        key = "ovl_" + ("overlap" if mode else "bulk")
        out[key + "_loss"] = _np(step(params, opt, flat, target))
        for name, x in vars(params).items():
            out[f"{key}_{name}"] = _np(x)
    return out


def slab_jobs(inp, world, exact):
    """The slab march (scene A, 24 steps), the ring on the +Z and -Z
    scenes, the slab-local illumination with one light and with two; at
    world 1 the single-device functions they are held to."""
    import torch
    import torch.distributed as dist

    from tbraymarcherplugin_tpu_torch.models.pipeline import (
        compute_illumination,
    )
    from tbraymarcherplugin_tpu_torch.ops import march as M
    from tbraymarcherplugin_tpu_torch.parallel import (
        compute_illumination_sharded_v2, make_mesh, march_lit_slab_ring,
        march_lit_slab_sharded,
    )

    mesh = make_mesh({"slab": world})
    params = _params(inp["a_vol"], inp["ramp_tf"])
    plans = _plans([LIGHT_A], DIMS)
    win = _t(WIN_A)
    lv = compute_illumination(params, plans, *NO_CLIP, DIMS)
    out = {"slab_lv": _np(lv)}
    args = (params.volume, params.tf_table, lv, _rays(inp, "a"), win,
            *NO_CLIP)
    out["slab"] = _np(march_lit_slab_sharded(mesh, *args, step_count=24))
    if exact:
        out["slab_single"] = _np(M.march_lit(*args, step_count=24,
                                             early_termination=2.0))
    for key in ("ring_p", "ring_n"):
        ring_args = (_t(inp["ring_vol"]), _t(inp["ring_tf"]),
                     torch.ones(DIMS), _rays(inp, key), win, *NO_CLIP)
        out[key] = _np(march_lit_slab_ring(mesh, *ring_args, step_count=24))
        if exact:
            out[key + "_single"] = _np(M.march_lit(*ring_args,
                                                   step_count=24))
    out["illum_one"] = _np(gather_z(compute_illumination_sharded_v2(
        mesh, _z_slab(params, dist), plans, *NO_CLIP, DIMS), dist))
    params2 = _params(inp["a_vol"], inp["ramp_tf"], (1.0, 0.7))
    plans2 = _plans([LIGHT_A, LIGHT_B], DIMS)
    chunk = compute_illumination_sharded_v2(mesh, _z_slab(params2, dist),
                                            plans2, *NO_CLIP, DIMS)
    out["illum_v2"] = _np(gather_z(chunk, dist))
    if exact:
        out["illum_single"] = _np(compute_illumination(params, plans,
                                                       *NO_CLIP, DIMS))
        out["illum2_single"] = _np(compute_illumination(params2, plans2,
                                                        *NO_CLIP, DIMS))
    return out


def v2_jobs(inp, world, exact):
    """Illumination v2 with a half-resolution light and with anisotropic
    dims (two lights each)."""
    import torch.distributed as dist

    from tbraymarcherplugin_tpu_torch.parallel import (
        compute_illumination_sharded_v2, make_mesh,
    )

    mesh = make_mesh({"slab": world})
    out = {}
    for i, (vdims, ldims) in enumerate(V2_CASES):
        params = _params(inp[f"v2_vol{i}"], inp["v2_tf"], (1.0, 0.6))
        chunk = compute_illumination_sharded_v2(
            mesh, _z_slab(params, dist), _plans([LIGHT_A, LIGHT_B], ldims),
            *NO_CLIP, ldims)
        out[f"v2_{i}"] = _np(gather_z(chunk, dist))
    return out


def _z_slab(params, dist):
    """``params`` with only this rank's Z slab of the volume."""
    import dataclasses

    n, r = dist.get_world_size(), dist.get_rank()
    z = params.volume.shape[2] // n
    return dataclasses.replace(
        params, volume=params.volume[:, :, r * z:(r + 1) * z].contiguous())


def gather_z(chunk, dist):
    import torch

    parts = [torch.empty_like(chunk) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, chunk.contiguous())
    return torch.cat(parts, dim=2)


JOBS = {
    1: (ray_jobs, shearwarp_jobs, diff_jobs, train_jobs, slab_jobs),
    2: (diff_jobs, train_jobs),
    4: (v2_jobs,),
    8: (ray_jobs, shearwarp_jobs, overlap_jobs, slab_jobs),
}


def main(inp_path, out_path):
    import torch
    import torch.distributed as dist

    from tbraymarcherplugin_tpu_torch.parallel import distributed as D

    torch.set_num_threads(1)
    D.initialize_multihost(os.environ["COORD"], device="cpu")
    world = dist.get_world_size()
    inp = dict(np.load(inp_path))
    out = {}
    for job in JOBS[world]:
        out.update(job(inp, world, exact=world == 1))
    if D.is_primary():
        np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(*sys.argv[1:3])
