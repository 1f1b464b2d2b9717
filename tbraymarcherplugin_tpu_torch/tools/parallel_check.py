"""The `parallel` paths across processes, each held against the
single-device path (computed on rank 0).

    python -m tbraymarcherplugin_tpu_torch.tools.parallel_check --nproc 4
    python -m tbraymarcherplugin_tpu_torch.tools.parallel_check --nproc 4 \\
        --device cpu --scene small

One process per GPU over NCCL (the default), or CPU processes over gloo
(``--device cpu``). The bench scene is `chip_smoke.py`'s (256^3 CT phantom,
bone TF, one light, 1920x1080, 150 planes; 480x270 rays for the marches);
``small`` is 24^3, 64x48, for a rehearsal on the CPU. Per path, one line:

- `shearwarp_lit_sharded_diff` (column slabs, float32 planes): the frame
  the same bits as the fused path, the loss within rtol 1e-5,
  the gradients within rtol 5e-3 and 1e-5 of the largest value (the JAX
  diff test's limits: the sums over ranks run in another order);
- `shearwarp_lit_sharded`: the same bits as `shearwarp_lit`;
- `render_lit_sharded` (ray tiles) against `render_lit_scene`, rtol 1e-5,
  atol 1e-6;
- `make_sharded_train_step`, one Adam step bulk and one overlapped: the
  loss against the single-process loss (rtol 1e-5), each mode's gradients
  against the single-process ones, |a - b|_2 / |b|_2 within 1e-5;
- `march_lit_slab_ring` and `march_lit_slab_sharded` against `march_lit`
  (with and without the snap; rtol 1e-4, atol 1e-5), and the slab-local
  illumination (each rank its slab) against `compute_illumination` (rtol
  1e-5, atol 1e-6).

Each line carries the host-clock time of the sharded call and the card's
name and power limit. Exits non-zero when a check fails; the last line is
a JSON summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

SCENES = {
    "bench": dict(dims=(256, 256, 256), size=(1920, 1080), planes=150,
                  rays=(480, 270), train_steps=64, march_steps=150),
    "small": dict(dims=(24, 24, 24), size=(64, 48), planes=20,
                  rays=(24, 16), train_steps=12, march_steps=20),
}
WINDOW = (0.5, 0.8)
CENTER = 0.55  # the fwd+bwd's window center, against the frame at WINDOW
LIGHT_DIR = (0.3, 0.1, -0.95)
CAM_POS, FOV = (0.1, -2.3, 0.4), 40.0
GRAD_LIMIT = 1e-5


def _card(device_type: str) -> str:
    if device_type == "cpu":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _excess(got, want, rtol: float) -> float:
    """max(|got - want| - rtol |want|): at most atol where they agree."""
    return float(((got - want).abs() - rtol * want.abs()).max())


def _rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b)) / max(
        float(torch.linalg.vector_norm(b)), 1e-30)


def _rank(rank: int, world: int, device_type: str, scene: str, store: str,
          out: str) -> None:
    import torch
    import torch.distributed as dist

    from .. import parallel as P
    from ..models import pipeline as PP
    from ..ops import march as M
    from ..ops import shearwarp as SW
    from ..ops import synthetic
    from ..ops import transfer as T
    from ..ops.rays import setup_rays
    from ..ops.shearwarp_grad import shearwarp_intermediate_fused_diff
    from ..ops.warp import warp_to_screen_fused
    from ..parallel import distributed as D
    from ..parallel.overlap import all_gather_cat
    from ..scene import Camera, ClipPlane, VolumeTransform

    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    D.initialize_multihost(f"file://{store}", world, rank,
                           device=device_type)
    dev = torch.device(device_type, rank) if device_type == "cuda" else \
        torch.device("cpu")
    s = SCENES[scene]
    dims, (width, height) = s["dims"], s["size"]
    card = _card(device_type)
    lines, ok = [], True
    primary = rank == 0

    def report(name, good, text, ms):
        nonlocal ok
        ok = ok and good
        line = (f"[parallel_check] world {world} {name}: {text} | sharded "
                f"call {ms:.2f} ms (host clock, rank 0) | "
                f"{'ok' if good else 'FAILED'} | {card}")
        lines.append(line)
        print(line, flush=True)

    def timed(fn):
        if device_type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        if device_type == "cuda":
            torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    try:
        volume = torch.from_numpy(synthetic.ct_like_phantom(dims, seed=0)
                                  ).to(dev)
        tf = T.tf_ct_bone(device=dev)
        transform = VolumeTransform.create()
        clip = transform.local_clip_plane(ClipPlane.disabled())
        cc, cd = clip.center, clip.direction
        cam = Camera.look_at(CAM_POS, 0.0, fov_degrees=FOV)
        plans = (PP.LightPlan.create(LIGHT_DIR, dims),)

        def params(center):
            return PP.RenderParams(
                volume.clone(), tf.clone(), torch.tensor(center, device=dev),
                torch.tensor(WINDOW[1], device=dev),
                torch.tensor([1.0], device=dev))

        def win(center):
            return torch.tensor([center, WINDOW[1], 1.0, 1.0], device=dev)

        with torch.no_grad():
            lv = PP.compute_illumination(params(WINDOW[0]), plans, cc, cd,
                                         dims)
        rays_mesh = P.make_mesh({"rays": world})
        slab_mesh = P.make_mesh({"slab": world})
        plan = SW.plan_shearwarp(cam, transform, dims, dims, width, height,
                                 max_planes=s["planes"])

        # the differentiable column-sharded shear-warp, float32 planes: with
        # bf16 planes each slab's pre-shear cotangent is rounded to bf16
        # before the sum over ranks, where one device rounds the total
        dtype = torch.float32
        args = (volume, tf, lv, plan)
        with torch.no_grad():
            target = P.shearwarp_lit_sharded_diff(
                rays_mesh, *args, win(WINDOW[0]), cc, cd, width, height,
                compute_dtype=dtype)
        img = P.shearwarp_lit_sharded_diff(
            rays_mesh, *args, win(CENTER), cc, cd, width, height,
            compute_dtype=dtype)
        (loss, grads), ms = timed(lambda: P.shearwarp_lit_sharded_diff(
            rays_mesh, *args, win(CENTER), cc, cd, width, height,
            target=target, compute_dtype=dtype))
        if primary:
            leaves = [x.clone().requires_grad_()
                      for x in (volume, tf, win(CENTER))]
            img1 = warp_to_screen_fused(shearwarp_intermediate_fused_diff(
                leaves[0], leaves[1], lv, plan, leaves[2], cc, cd,
                compute_dtype=dtype), plan, width, height)
            loss1 = ((img1 - target) ** 2).sum()
            loss1.backward()
            loss1 = loss1.detach()
            errs = [_excess(g, x.grad, 5e-3)
                    / (1e-5 * max(float(x.grad.abs().max()), 1.0))
                    for g, x in zip(grads, leaves)]
            same = torch.equal(img, img1.detach())
            lerr = abs(float(loss) - float(loss1)) / abs(float(loss1))
            report("shearwarp_lit_sharded_diff",
                   same and lerr <= 1e-5 and max(errs) <= 1.0,
                   f"{width}x{height}, {plan.k} {str(dtype)[6:]} planes, "
                   f"n2 {plan.n2} in {world} slabs: the frame the same bits "
                   f"{same}; loss {float(loss):.6f} vs {float(loss1):.6f} "
                   f"(rel {lerr:.2e}, limit 1e-5); gradients (dvolume, dtf, "
                   f"dwindow) max(|d| - 5e-3 |x|) over 1e-5 max(|x|, 1) "
                   f"{', '.join(f'{e:.3f}' for e in errs)} (limit 1)", ms)
            del leaves, img1, loss1
        del img, target, grads

        # the forward column-sharded shear-warp
        got, ms = timed(lambda: P.shearwarp_lit_sharded(
            rays_mesh, volume, tf, lv, plan, win(WINDOW[0]), cc, cd, width,
            height))
        if primary:
            with torch.no_grad():
                want = SW.shearwarp_lit(volume, tf, lv, plan, win(WINDOW[0]),
                                        cc, cd, width, height, block_size=16)
            same = torch.equal(got, want)
            report("shearwarp_lit_sharded", same,
                   f"dense composite, float32: the same bits as "
                   f"shearwarp_lit {same}", ms)

        # ray tiles: the render and the train step
        rays = setup_rays(cam, transform, *s["rays"], device=dev)
        steps = s["train_steps"]
        got, ms = timed(lambda: P.render_lit_sharded(
            rays_mesh, params(WINDOW[0]), rays, cc, cd, plans, dims,
            step_count=steps))
        flat, _ = P.pad_rays_for_mesh(rays, world)
        with torch.no_grad():
            tgt = PP.render_lit_scene(params(WINDOW[0]), flat, cc, cd, plans,
                                      dims, step_count=steps)
        if primary:
            want = tgt[:got[..., 0].numel()].reshape(got.shape)
            err = _excess(got, want, 1e-5)
            report("render_lit_sharded", err <= 1e-6,
                   f"{s['rays'][0]}x{s['rays'][1]} rays, {steps} steps: "
                   f"max(|d| - 1e-5 |x|) {err:.3e} (limit 1e-6), the same "
                   f"bits {torch.equal(got, want)}", ms)

        def l2(image, t):
            return ((image - t) ** 2).sum()

        modes = []
        for overlap in (False, True):
            step, make_opt = P.make_sharded_train_step(
                rays_mesh, l2, cc, cd, plans, dims, step_count=steps,
                overlap_allreduce=overlap)
            p = params(CENTER)
            leaves = [x.requires_grad_() for x in vars(p).values()]
            opt = make_opt(leaves)
            loss, ms = timed(lambda: step(p, opt, flat, tgt))
            modes.append((loss, [x.grad for x in leaves], ms))
        if primary:
            p = params(CENTER)
            leaves = [x.requires_grad_() for x in vars(p).values()]
            loss1 = l2(PP.render_lit_scene(p, flat, cc, cd, plans, dims,
                                           step_count=steps), tgt)
            loss1.backward()
            loss1 = loss1.detach()
            for name, (loss, grads, ms) in zip(("bulk", "overlap"), modes):
                lerr = abs(float(loss) - float(loss1)) / abs(float(loss1))
                gerr = max(_rel(g, x.grad) for g, x in zip(grads, leaves))
                report(f"make_sharded_train_step ({name})",
                       lerr <= 1e-5 and gerr <= GRAD_LIMIT,
                       f"one Adam step: loss rel {lerr:.2e} (limit 1e-5), "
                       f"gradients vs one process, largest |a - b|_2 / "
                       f"|b|_2 over the leaves {gerr:.3e} (limit "
                       f"{GRAD_LIMIT:.0e})", ms)
            del leaves, loss1
        del modes

        # Z slabs: the two marches and the slab-local illumination
        wf = win(WINDOW[0])
        margs = (volume, tf, lv, rays, wf, cc, cd)
        ms_steps = s["march_steps"]
        for name, fn, kw in (
                ("march_lit_slab_ring", P.march_lit_slab_ring, {}),
                ("march_lit_slab_sharded", P.march_lit_slab_sharded,
                 dict(early_termination=2.0))):
            got, ms = timed(lambda: fn(slab_mesh, *margs,
                                       step_count=ms_steps))
            if primary:
                with torch.no_grad():
                    want = M.march_lit(*margs, step_count=ms_steps, **kw)
                err = _excess(got, want, 1e-4)
                report(name, err <= 1e-5,
                       f"{ms_steps} steps: max(|d| - 1e-4 |x|) {err:.3e} "
                       f"(limit 1e-5), the same bits "
                       f"{torch.equal(got, want)}", ms)
        p = params(WINDOW[0])
        zc = dims[2] // world
        own = dataclasses.replace(p, volume=p.volume[
            :, :, rank * zc:(rank + 1) * zc].contiguous())
        chunk, ms = timed(lambda: P.compute_illumination_sharded_v2(
            slab_mesh, own, plans, cc, cd, dims))
        got = all_gather_cat(chunk, 2, slab_mesh.get_group("slab"))
        if primary:
            with torch.no_grad():
                want = PP.compute_illumination(p, plans, cc, cd, dims)
            err = _excess(got, want, 1e-5)
            report("compute_illumination_sharded_v2", err <= 1e-6,
                   f"max(|d| - 1e-5 |x|) {err:.3e} (limit 1e-6), the same "
                   f"bits {torch.equal(got, want)}", ms)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if primary:
        with open(out, "w") as f:
            json.dump(dict(ok=ok, world=world, device=card, lines=lines), f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scene", choices=sorted(SCENES), default="bench")
    a = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if a.device == "cuda":
        if torch.cuda.device_count() < a.nproc:
            print(f"parallel_check: {a.nproc} GPUs asked for, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        from ..ops import _kernels

        _kernels.build()  # once, before the ranks load it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        mp.spawn(_rank, args=(a.nproc, a.device, a.scene,
                              os.path.join(tmp, "store"), out),
                 nprocs=a.nproc)
        with open(out) as f:
            res = json.load(f)
    res.pop("lines")
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
