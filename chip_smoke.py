#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: compile the kernels from `tbraymarcherplugin_tpu_torch/csrc`
     (one nvcc per source, all at once);
  3. kernels: each of K1-K4 against its plain PyTorch version on the card,
     at the shapes of the main path (max abs error against a stated limit,
     CUDA-event times of both);
  4. slice: the full lit frame (256^3 CT phantom, bone TF, window
     (0.5, 0.8), one light, 1920x1080, 150 planes, jitter on) through
     `Renderer`: one illumination rebuild, four orbit frames, one light
     move; every forward kernel's launch counter must rise; frames are
     checked for finiteness, coverage and distinct checksums, against the
     port's all-plain path on the card, and, on a small scene, against the
     CPU;
  5. fwd+bwd: the differentiable frame of the same scene (bf16 planes, no
     jitter) through `models.pipeline.render_lit_scene`: three
     `loss.backward()` steps of the L2 loss against the frame at window
     (0.5, 0.8), at window centers 0.55, 0.56, 0.57; every leaf's gradient
     must be finite and nonzero, (loss, sum |dTF|) must differ from step to
     step and all eight kernels' counters must rise; then each backward
     kernel K5-K8 against its plain version on the inputs the path gave it
     (and against itself: two launches must give the same bits),
     the gradients against the all-plain path on the card, and a 24^3
     fwd+bwd on the card against the CPU;
  6. march: four fly-through frames with the camera inside the volume
     (same scene, jitter on), where shear-warp has no plan and `Renderer`
     marches through K9: K9's counter must rise and K1's must not; frames
     are checked for finiteness, coverage and distinct checksums; K9
     against its plain version on the path's inputs, and on the bench
     camera forced to march (`march_impl="pallas"`), both timed; the frame
     against the all-plain path; a 24^3 frame inside the volume on the card
     against the CPU; one frame back outside takes K1 again; and a small
     `render_lit_scene(march_impl="blocked")` fwd+bwd on the card against
     the CPU.
Then a JSON line of the kernels, the card line, and the result line.

There is no CPU path: without a CUDA device the script exits with an error.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

DIMS = (256, 256, 256)
WIDTH, HEIGHT, STEPS = 1920, 1080, 150
WINDOW = (0.5, 0.8)
FWD_BWD_CENTERS = (0.55, 0.56, 0.57)
LIGHT_DIR = (0.3, 0.1, -0.95)
CAM_POS = (0.1, -2.3, 0.4)
FOV = 40.0

# Max abs error of a kernel against its plain version on the same inputs.
# The kernels round every operation as their plain versions do (see
# csrc/common.cuh); what remains are ulps of expf/logf against PyTorch's
# exp/log (K1, K3). K2 and K4 have no transcendentals and agree exactly.
LIMITS = {"composite": 2e-5, "row_lerp": 1e-5, "tf_alpha": 1e-6,
          "light_scan": 1e-5, "march": 2e-5}
# Backward kernels against their plain versions on the same inputs, as the
# largest error over the largest plain value of each output (K5: dW, dL, dTF,
# d window; K6: d rows; K7: d opacity, sum m, m_0; K8: d values, dTF,
# d window). The sums run in another order than the plain versions' (K5,
# K6, K8), and K5/K8 meet expf/logf ulps; K5's dW and dL are bf16 on this
# path, where an ulp of float32 can round to the next bf16 value: one bf16
# ulp at the largest value is 2^-8. K7 does the plain version's operations
# in its order and agrees exactly.
BWD_LIMITS = {"composite_bwd": 2.0 ** -8, "row_lerp_bwd": 1e-5,
              "light_scan_bwd": 0.0, "tf_alpha_bwd": 1e-4}
# Kernel frame vs all-plain frame, RGBA: K3's exp/log ulps reach the light
# volume and move the frame by 7.5e-5 on the bench scene (PERF.md).
FRAME_VS_PLAIN_LIMIT = 1e-4
# Gradients of the kernel path vs the all-plain path on the card (bf16
# planes in both) and vs the CPU at 24^3 (float32 planes in both), each as
# |got - want|_2 / |want|_2: an ulp of float32 between the two (expf/logf,
# sum order) can round a bf16 plane cotangent to the next value (2^-8
# relative) or flip one pixel's 0.95 snap, which moves that pixel's whole
# contribution.
GRAD_VS_PLAIN_LIMIT = 1e-2
# Phase 6: the fly-through camera, inside the 256^3 volume's dominant slab
# (no shear-warp plan), looking at the center through the phantom's bone
# shell; every ray of its frame hits bone (alpha coverage 1.0 on the CPU at
# 24^3 and 64^3), far above the 5% coverage check. Successive frames step
# the camera along FLY_STEP.
FLY_POS, FLY_STEP, FLY_FOV = (0.1, -0.3, 0.05), (0.01, 0.005, 0.0), 60.0
# A march frame on the card (float32 throughout) against the CPU at 24^3:
# the light volume meets K3's exp/log ulps, as in phase 4's frame limit.
SMALL_MARCH_LIMIT = 1e-4
# bf16 plane storage (card) vs float32 (CPU), the JAX package's own bounds
# for bf16 against f32 (tests/test_shearwarp_pallas.py::test_fused_bf16_close)
SMALL_MEAN_LIMIT, SMALL_MAX_LIMIT = 2e-3, 0.06

REPLACES = {
    "composite": "tbraymarcherplugin_tpu/ops/shearwarp_pallas.py:146",
    "row_lerp": "tbraymarcherplugin_tpu/ops/pallas_warp.py:34",
    "tf_alpha": "tbraymarcherplugin_tpu/ops/pallas_tf.py:29",
    "light_scan": "tbraymarcherplugin_tpu/ops/pallas_lighting.py:57",
    "composite_bwd": "tbraymarcherplugin_tpu/ops/shearwarp_grad.py:109",
    "row_lerp_bwd": "tbraymarcherplugin_tpu/ops/pallas_warp.py:93",
    "light_scan_bwd": "tbraymarcherplugin_tpu/ops/pallas_lighting.py:184",
    "tf_alpha_bwd": "tbraymarcherplugin_tpu/ops/pallas_tf.py:291",
    "march": "tbraymarcherplugin_tpu/ops/pallas_march.py:359",
}
SOURCES = {
    "composite": "tbraymarcherplugin_tpu_torch/csrc/composite.cu",
    "row_lerp": "tbraymarcherplugin_tpu_torch/csrc/row_lerp.cu",
    "tf_alpha": "tbraymarcherplugin_tpu_torch/csrc/tf_alpha.cu",
    "light_scan": "tbraymarcherplugin_tpu_torch/csrc/light_scan.cu",
    "composite_bwd": "tbraymarcherplugin_tpu_torch/csrc/composite_bwd.cu",
    "row_lerp_bwd": "tbraymarcherplugin_tpu_torch/csrc/row_lerp_bwd.cu",
    "light_scan_bwd": "tbraymarcherplugin_tpu_torch/csrc/light_scan_bwd.cu",
    "tf_alpha_bwd": "tbraymarcherplugin_tpu_torch/csrc/tf_alpha_bwd.cu",
    "march": "tbraymarcherplugin_tpu_torch/csrc/march.cu",
}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def kernel_table():
    """(name, module, wrapper name) of each kernel, K1-K9."""
    from tbraymarcherplugin_tpu_torch.ops import composite, fused_march
    from tbraymarcherplugin_tpu_torch.ops import light_scan, shearwarp_grad
    from tbraymarcherplugin_tpu_torch.ops import tf_alpha, warp

    return (("composite", composite, "composite"),
            ("row_lerp", warp, "row_lerp"),
            ("tf_alpha", tf_alpha, "windowed_tf_alpha"),
            ("light_scan", light_scan, "propagate_face_scan"),
            ("composite_bwd", shearwarp_grad, "composite_bwd"),
            ("row_lerp_bwd", warp, "row_lerp_bwd"),
            ("light_scan_bwd", light_scan, "propagate_face_scan_bwd"),
            ("tf_alpha_bwd", tf_alpha, "windowed_tf_alpha_bwd"),
            ("march", fused_march, "march_lit_fused"))


@contextlib.contextmanager
def all_plain():
    """Swap each kernel wrapper for its plain PyTorch version in the module
    that defines it (every caller looks it up there at call time), so the
    whole path runs plain on the card."""
    with contextlib.ExitStack() as stack:
        for _, mod, fn in kernel_table():
            stack.enter_context(
                mock.patch.object(mod, fn, getattr(mod, fn + "_plain")))
        yield


@contextlib.contextmanager
def capture_calls(calls: dict, names):
    """Record the arguments of every call of the named kernels' wrappers
    (the wrapper still runs), for replaying them against the plain
    versions."""
    with contextlib.ExitStack() as stack:
        for name, mod, fn in kernel_table():
            if name not in names:
                continue
            real = getattr(mod, fn)

            def spy(*args, _real=real, _name=name, **kw):
                calls.setdefault(_name, []).append((args, kw))
                return _real(*args, **kw)

            spy.launches = 0  # the wrapper counts on the name it is bound to
            stack.enter_context(mock.patch.object(mod, fn, spy))
        yield


def replay_bwd(torch, name, real, plain, used, card, results):
    """Hold backward kernel ``name`` against its plain version, and against
    itself, on the recorded calls ``used``; time both."""
    rel, abs_err = 0.0, 0.0
    for args, kw in used:
        got_all, again, want_all = (
            as_tuple(f(*args, **kw)) for f in (real, real, plain))
        check(all(torch.equal(a, b) for a, b in zip(got_all, again)),
              f"{name}: two launches on the same inputs differ")
        for got, want in zip(got_all, want_all):
            d = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            check(math.isfinite(d), f"{name}: non-finite output")
            abs_err = max(abs_err, d)
            rel = max(rel, d / scale if scale > 0 else d)
    ms = sum(cuda_ms(torch, lambda a=a, k=k: real(*a, **k), 5)
             for a, k in used)
    plain_ms = sum(cuda_ms(torch, lambda a=a, k=k: plain(*a, **k), 1)
                   for a, k in used)
    results[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    print(f"[kernel] {name}: max_abs_err {abs_err:.3e}, relative to the "
          f"plain output's max {rel:.3e} (limit {BWD_LIMITS[name]:.1e}) | "
          f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | {card}",
          flush=True)
    check(rel <= BWD_LIMITS[name], f"{name} disagrees with its plain version")


def fwd_bwd_phase(torch, volume, cam, transform, clip, card, results):
    """Phase 5 (see the module docstring); adds K5-K8 to ``results``."""
    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays

    fields = ("volume", "tf_table", "window_center", "window_width",
              "light_intensities")

    def make_step(vol, width, height, dtype=None, **plan_kw):
        """An L2 fwd+bwd step of the lit frame of ``vol`` against its frame
        at window (0.5, 0.8), planes stored as ``dtype`` (default: bf16 on
        the card): center -> (loss, gradient of each leaf, frame)."""
        dims = tuple(vol.shape)
        dev = vol.device
        plan = SW.plan_shearwarp(cam, transform, dims, dims, width, height,
                                 **plan_kw)
        rays = setup_rays(cam, transform, width, height)
        plans = (PP.LightPlan.create(LIGHT_DIR, dims),)

        def params(center):
            return PP.RenderParams(
                vol.detach(), T.tf_ct_bone(device=dev),
                torch.tensor(center, device=dev),
                torch.tensor(WINDOW[1], device=dev),
                torch.tensor([1.0], device=dev))

        def render(p):
            return PP.render_lit_scene(p, rays, clip.center, clip.direction,
                                       plans, dims, shearwarp_plan=plan,
                                       shearwarp_dtype=dtype)

        with torch.no_grad():
            target = render(params(WINDOW[0]))

        def step(center):
            p = params(center)
            for f in fields:
                getattr(p, f).requires_grad_()
            img = render(p)
            loss = ((img - target) ** 2).mean()
            loss.backward()
            return (loss.detach(), [getattr(p, f).grad for f in fields],
                    img.detach())

        return step

    table = kernel_table()[:8]  # K1-K8: the shear-warp fwd+bwd
    step = make_step(volume, WIDTH, HEIGHT, max_planes=STEPS)
    for _, mod, fn in table:
        getattr(mod, fn).launches = 0
    outs, step_ms = [], []
    for c in FWD_BWD_CENTERS:
        out, ms = host_ms(torch, lambda c=c: step(c))
        outs.append(out)
        step_ms.append(ms)
    launches = {name: getattr(mod, fn).launches for name, mod, fn in table}
    print(f"[fwd+bwd] launches {launches} | ms per step (host clock) "
          f"{', '.join(f'{m:.2f}' for m in step_ms)} | {card}", flush=True)
    for name, _, _ in table:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the fwd+bwd path")
    keys = []
    for loss, grads, _ in outs:
        for f, g in zip(fields, grads):
            check(g is not None and bool(torch.isfinite(g).all())
                  and bool((g != 0).any()), f"gradient of {f}: {g}")
        keys.append((float(loss), float(grads[1].abs().sum())))
    print(f"[fwd+bwd] (loss, sum |dTF|) per step: {keys}", flush=True)
    check(len(set(keys)) == len(keys), f"steps repeat: {keys}")

    # K5-K8 on the inputs the path gave them.
    calls = {}
    bwd = table[4:]
    with capture_calls(calls, [name for name, _, _ in bwd]):
        step(FWD_BWD_CENTERS[0])
    # the captured inputs are autograd intermediates: without no_grad the
    # plain versions would record a graph of every plane's temporaries
    with torch.no_grad():
        for name, mod, fn in bwd:
            # K6 runs once per warp pass (both are timed, as K2's); K7 and
            # K8 once per light face (the first face is timed, as K4's)
            used = calls[name] if name == "row_lerp_bwd" else calls[name][:1]
            replay_bwd(torch, name, getattr(mod, fn),
                       getattr(mod, fn + "_plain"), used, card, results)
            results[name]["launches"] = launches[name]
    del calls

    # The gradients against the all-plain path on the card.
    with all_plain():
        _, want, _ = step(FWD_BWD_CENTERS[0])
    errs = {f: float((a - b).norm() / b.norm())
            for f, a, b in zip(fields, outs[0][1], want)}
    print(f"[fwd+bwd] gradients vs all-plain path on the card, |d|_2 / "
          f"|plain|_2: {errs} (limit {GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "kernel gradients != plain gradients")
    del outs, want

    # Small scene, the card against the CPU: the image of the fwd+bwd path
    # with bf16 planes within phase 4's bounds; the gradients with float32
    # planes on both (bf16 values move by up to half a TF texel, which moves
    # a gradient by as much as the gradient itself).
    small = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    cpu = torch.device("cpu")
    card_bf16 = make_step(small.to(volume.device), 64, 48, max_planes=20)
    card_f32 = make_step(small.to(volume.device), 64, 48,
                         dtype=torch.float32, max_planes=20)
    on_cpu = make_step(small, 64, 48, max_planes=20)
    c0 = FWD_BWD_CENTERS[0]
    (_, _, img), (_, grads, _) = card_bf16(c0), card_f32(c0)
    _, want, want_img = on_cpu(c0)
    diff = (img.cpu() - want_img).abs()
    errs = {f: float((a.cpu() - b).norm() / b.norm())
            for f, a, b in zip(fields, grads, want)}
    print(f"[small] fwd+bwd, card vs CPU at 24^3, 64x48: image (bf16 planes) "
          f"mean {float(diff.mean()):.2e} (limit {SMALL_MEAN_LIMIT:.0e}), max "
          f"{float(diff.max()):.2e} (limit {SMALL_MAX_LIMIT:.0e}); gradients "
          f"(float32 planes), |d|_2 / |CPU|_2: {errs} (limit "
          f"{GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(float(diff.mean()) < SMALL_MEAN_LIMIT
          and float(diff.max()) < SMALL_MAX_LIMIT, "card != CPU on 24^3")
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "card gradients != CPU gradients on 24^3")


def march_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results):
    """Phase 6 (see the module docstring); adds K9 to ``results``."""
    from tbraymarcherplugin_tpu_torch.models import pipeline as PP
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import fused_march as K9
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import Camera, ClipPlane

    dev = volume.device

    def make_renderer(vol=volume, table=tf, steps=STEPS, **cfg):
        r = Renderer(vol, tf_table=table, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=steps, jitter=True,
                                           **cfg),
                     device=vol.device)
        r.add_light("sun", light)
        return r

    cams = [Camera.look_at(tuple(p + i * d for p, d in zip(FLY_POS, FLY_STEP)),
                           (0.0, 0.0, 0.0), fov_degrees=FLY_FOV)
            for i in range(4)]
    r = make_renderer()
    r.ensure_lighting()
    K1.composite.launches = 0
    K9.march_lit_fused.launches = 0
    frames, frame_ms = [], []
    for c in cams:
        img, ms = host_ms(torch, lambda c=c: r.render(c, WIDTH, HEIGHT))
        frames.append(img)
        frame_ms.append(ms)
    launches = {"march": K9.march_lit_fused.launches,
                "composite": K1.composite.launches}
    print(f"[march] fly-through launches {launches} | frames "
          f"{', '.join(f'{m:.2f}' for m in frame_ms)} ms (host clock) | "
          f"{card}", flush=True)
    check(r._sw_plan is None, "the fly-through camera has a shear-warp plan")
    check(launches["march"] > 0, "kernel march was not launched by the march "
          "path")
    check(launches["composite"] == 0, "the march path launched K1")
    results["march"] = dict(launches=launches["march"])
    sums, covers = [], []
    for f in frames:
        check(tuple(f.shape) == (HEIGHT, WIDTH, 4), f"frame shape {f.shape}")
        check(bool(torch.isfinite(f).all()), "non-finite frame")
        covers.append(float((f[..., 3] > 0.01).float().mean()))
        check(covers[-1] > 0.05, f"alpha coverage {covers[-1]:.3f} too small")
        sums.append(float(f.double().sum()))
    check(len(set(sums)) == len(sums), f"frame checksums repeat: {sums}")
    del frames

    # K9 against its plain version on the path's inputs, at the fly-through
    # camera and at the bench camera forced to march
    timed = {}
    for label, rend, c in (("fly-through", r, cams[0]),
                           ("bench camera", make_renderer(
                               march_impl="pallas"), cam)):
        calls = {}
        with capture_calls(calls, ["march"]):
            rend.render(c, WIDTH, HEIGHT)
        (args, kw), = calls["march"]
        got = K9.march_lit_fused(*args, **kw)
        want = K9.march_lit_fused_plain(*args, **kw)
        d = (got - want).abs()
        err = float(d.max())
        check(math.isfinite(err), "march: non-finite output")
        flips = int((d[..., 3] > 0.5).sum())  # early-termination flips
        ms = cuda_ms(torch, lambda: K9.march_lit_fused(*args, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: K9.march_lit_fused_plain(*args,
                                                                    **kw), 1)
        timed[label] = (err, ms, plain_ms)
        print(f"[kernel] march ({label}): max_abs_err {err:.3e} (limit "
              f"{LIMITS['march']:.0e}), pixels whose snap flipped {flips} | "
              f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | coverage "
              f"{float((want[..., 3] > 0.01).float().mean()):.3f} | {card}",
              flush=True)
        check(err <= LIMITS["march"], "march disagrees with its plain version")
        del calls, args, kw, got, want, d
    err, ms, plain_ms = timed["fly-through"]
    results["march"].update(max_abs_err=max(t[0] for t in timed.values()),
                            ms=ms, plain_ms=plain_ms)

    # the frame against the all-plain path (frame index 0 in both)
    rp = make_renderer()
    with all_plain():
        ref = rp.render(cams[0], WIDTH, HEIGHT)
    got = make_renderer().render(cams[0], WIDTH, HEIGHT)
    frame_err = float((got - ref).abs().max())
    print(f"[march] fly-through frame vs all-plain path on the card: "
          f"max_abs_err {frame_err:.3e} (limit {FRAME_VS_PLAIN_LIMIT:.0e}) | "
          f"coverage {', '.join(f'{x:.3f}' for x in covers)} | checksums "
          f"{', '.join(f'{x:.1f}' for x in sums)}", flush=True)
    check(frame_err <= FRAME_VS_PLAIN_LIMIT, "kernel frame != plain frame")
    del rp, ref, got

    # back outside: the shear-warp plan and K1 again, no K9
    K1.composite.launches = 0
    K9.march_lit_fused.launches = 0
    r.render(cam, WIDTH, HEIGHT)
    check(r._sw_plan is not None and K1.composite.launches > 0
          and K9.march_lit_fused.launches == 0,
          "the frame back outside did not take shear-warp (K1)")
    del r

    # 24^3 inside the volume: a march frame on the card against the CPU
    small = torch.from_numpy(synthetic.ct_like_phantom((24, 24, 24), seed=0))
    imgs = [make_renderer(small.to(d), T.tf_ct_bone(device=d), 20)
            .render(cams[0], 64, 48).cpu() for d in (dev, torch.device("cpu"))]
    small_err = float((imgs[0] - imgs[1]).abs().max())

    # ... and a small fwd+bwd through the blocked march
    dims = (24, 24, 24)
    rays = {d: setup_rays(cams[0], transform, 64, 48, device=d)
            for d in (dev, torch.device("cpu"))}
    clip = transform.local_clip_plane(ClipPlane.disabled())
    plans = (PP.LightPlan.create(LIGHT_DIR, dims),)
    fields = ("volume", "tf_table", "window_center", "window_width",
              "light_intensities")
    grads = []
    for d in (dev, torch.device("cpu")):
        p = PP.RenderParams(small.to(d), T.tf_ct_bone(device=d),
                            torch.tensor(0.55, device=d),
                            torch.tensor(WINDOW[1], device=d),
                            torch.tensor([1.0], device=d))
        for f in fields:
            getattr(p, f).requires_grad_()
        img = PP.render_lit_scene(p, rays[d], clip.center, clip.direction,
                                  plans, dims, step_count=20,
                                  march_impl="blocked")
        (img ** 2).mean().backward()
        grads.append([getattr(p, f).grad.cpu() for f in fields])
    errs = {f: float((a - b).norm() / b.norm())
            for f, a, b in zip(fields, *grads)}
    print(f"[small] march at 24^3, 64x48, inside: frame card vs CPU max "
          f"{small_err:.2e} (limit {SMALL_MARCH_LIMIT:.0e}); blocked-march "
          f"fwd+bwd gradients, |d|_2 / |CPU|_2: {errs} (limit "
          f"{GRAD_VS_PLAIN_LIMIT:.0e})", flush=True)
    check(small_err <= SMALL_MARCH_LIMIT, "march frame: card != CPU on 24^3")
    check(all(g.abs().max() > 0 for g in grads[1]), "a zero CPU gradient")
    check(max(errs.values()) <= GRAD_VS_PLAIN_LIMIT,
          "blocked-march gradients: card != CPU on 24^3")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    from tbraymarcherplugin_tpu_torch.ops import _kernels
    from tbraymarcherplugin_tpu_torch.ops import composite as K1
    from tbraymarcherplugin_tpu_torch.ops import light_scan as K4
    from tbraymarcherplugin_tpu_torch.ops import lighting as Lt
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
    from tbraymarcherplugin_tpu_torch.ops import synthetic
    from tbraymarcherplugin_tpu_torch.ops import tf_alpha as K3
    from tbraymarcherplugin_tpu_torch.ops import transfer as T
    from tbraymarcherplugin_tpu_torch.ops import warp as K2
    from tbraymarcherplugin_tpu_torch.ops.rays import jitter_values
    from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
    from tbraymarcherplugin_tpu_torch.scene import (
        Camera, ClipPlane, DirLight, VolumeTransform, orbit_camera,
    )
    from tbraymarcherplugin_tpu_torch.utils.volume_info import (
        WindowingParameters,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # --- 1. environment ----------------------------------------------------
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([_kernels._nvcc(), "--version"]).splitlines()[-1]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvcc: {nvcc} | device: {torch.cuda.get_device_name(0)} | "
          f"card: {card}", flush=True)

    # --- 2. build ----------------------------------------------------------
    path, build_s = _kernels.build()
    _kernels.load()
    print(f"[build] {path.name} in {build_s:.1f} s", flush=True)

    # --- 3. kernels at the main path's shapes --------------------------------
    volume = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0)).to(dev)
    tf = T.tf_ct_bone(device=dev)
    windowing = WindowingParameters(*WINDOW)
    win = windowing.as_vec4(dev)
    transform = VolumeTransform.create()
    clip = transform.local_clip_plane(ClipPlane.disabled())
    light = DirLight.create(LIGHT_DIR, 1.0)
    cam = Camera.look_at(CAM_POS, 0.0, fov_degrees=FOV)
    results = {}

    def record(name, got, want, ms, plain_ms):
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err), f"{name}: non-finite output")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"[kernel] {name}: max_abs_err {err:.3e} (limit "
              f"{LIMITS[name]:.0e}) | kernel {ms:.3f} ms | plain "
              f"{plain_ms:.3f} ms | {card}", flush=True)
        check(err <= LIMITS[name], f"{name} disagrees with its plain version")

    # K3 and K4 on the primary face of the light at 256^3.
    local_dir = transform.local_light_direction(light)
    axes = Lt.local_light_major_axes(local_dir)
    face = axes.faces[0]
    fp = Lt.plan_face_propagation(face, -np.asarray(local_dir, np.float64),
                                  DIMS, axes.weights[0])
    values = Lt._const_shift_trilinear(volume, DIMS, fp.uvw_offset).contiguous()
    step = float(np.float32(fp.step_size) * np.float32(100.0))
    got = K3.windowed_tf_alpha(values, tf, win, step)
    want = K3.windowed_tf_alpha_plain(values, tf, win, step)
    alpha_args = (values, tf, win, step)
    record("tf_alpha", got, want,
           cuda_ms(torch, lambda: K3.windowed_tf_alpha(*alpha_args), 20),
           cuda_ms(torch, lambda: K3.windowed_tf_alpha_plain(*alpha_args), 3))

    opacity = Lt.occluder_opacity_volume(volume, tf, win, DIMS, fp.uvw_offset,
                                         fp.step_size, clip.center,
                                         clip.direction)
    ax = Lt.transposed_axes(face)
    op_t = opacity.permute(ax)
    if Lt.face_direction(face) == -1:
        op_t = op_t.flip(2)
    op_scan = op_t.movedim(2, 0).contiguous()
    uv = np.asarray(fp.uv_offset, np.float32)
    offs = (uv[0] * np.float32(DIMS[ax[0]]), uv[1] * np.float32(DIMS[ax[1]]))
    alpha = np.float32(1.0) * np.float32(axes.weights[0])
    got = K4.propagate_face_scan(op_scan, *offs, alpha)
    want = K4.propagate_face_scan_plain(op_scan, *offs, alpha)
    scan_args = (op_scan, *offs, alpha)
    record("light_scan", got, want,
           cuda_ms(torch, lambda: K4.propagate_face_scan(*scan_args), 5),
           cuda_ms(torch, lambda: K4.propagate_face_scan_plain(*scan_args), 2))

    # K1 on the full frame's plan, bf16 streams, jitter on.
    light_volume = Lt.reset_all_lights(volume, tf, win, clip.center,
                                       clip.direction, [(local_dir, 1.0)],
                                       DIMS)
    plan = SW.plan_shearwarp(cam, transform, DIMS, DIMS, WIDTH, HEIGHT,
                             max_planes=STEPS)
    check(plan is not None, "no shear-warp plan for the bench camera")
    jit = jitter_values(plan.n2, plan.n1, 0, device=dev)
    ops = K1.prepare_composite(volume, tf, light_volume, plan, win,
                               clip.center, clip.direction, jitter=jit)
    check(ops["W"].dtype == torch.bfloat16, "planes are not bf16 on the card")
    inter = K1.composite(**ops)
    want = K1.composite_plain(**ops)
    record("composite", inter, want,
           cuda_ms(torch, lambda: K1.composite(**ops), 10),
           cuda_ms(torch, lambda: K1.composite_plain(**ops), 2))
    print(f"[kernel] composite plan: n1={plan.n1} n2={plan.n2} K={plan.k} "
          f"axis={plan.axis} swap_warp={plan.swap_warp}", flush=True)

    # K2: both warp passes of the frame.
    p1r, p2r, pdr, Wd, Hd = SW.warp_rows(plan, WIDTH, HEIGHT)
    idx1 = K2.pass1_index(plan, Wd, p1r, p2r, pdr, dev)
    rows1 = inter.transpose(1, 2).reshape(4 * plan.n2, plan.n1)
    M = K2.row_lerp(rows1, idx1, 4)
    idx2, _ = SW.screen_fields(plan, Wd, Hd, p1r, p2r, pdr, dev)
    rows2 = M.view(4, plan.n2, Wd).transpose(1, 2).reshape(4 * Wd, plan.n2)
    passes = ((rows1, idx1), (rows2, idx2))
    err_in = [(K2.row_lerp(r, i, 4), K2.row_lerp_plain(r, i, 4)) for r, i in passes]
    record("row_lerp", torch.cat([a.flatten() for a, _ in err_in]),
           torch.cat([b.flatten() for _, b in err_in]),
           sum(cuda_ms(torch, lambda r=r, i=i: K2.row_lerp(r, i, 4), 20)
               for r, i in passes),
           sum(cuda_ms(torch, lambda r=r, i=i: K2.row_lerp_plain(r, i, 4), 3)
               for r, i in passes))
    spread = float((idx1.amax(1) - idx1.amin(1)).max())
    print(f"[kernel] row_lerp pass-1 index spread per row: {spread:.1f} "
          f"texels (exact at any spread)", flush=True)
    del ops, inter, want, got, opacity, op_scan, values, M, err_in

    # --- 4. the slice ------------------------------------------------------
    def make_renderer():
        r = Renderer(volume, tf_table=tf, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=STEPS, jitter=True),
                     device=dev)
        r.add_light("sun", light)
        return r

    radius = math.hypot(CAM_POS[0], CAM_POS[1])
    angle0 = math.atan2(CAM_POS[1], CAM_POS[0])
    cams = [orbit_camera(angle0 + 0.2 * i, radius, CAM_POS[2],
                         fov_degrees=FOV) for i in range(4)]
    kernels = (K1.composite, K2.row_lerp, K3.windowed_tf_alpha,
               K4.propagate_face_scan)
    names = ("composite", "row_lerp", "tf_alpha", "light_scan")
    rk = make_renderer()
    for k in kernels:
        k.launches = 0
    _, rebuild_ms = host_ms(torch, rk.ensure_lighting)
    frames, frame_ms = [], []
    for c in cams:
        img, ms = host_ms(torch, lambda c=c: rk.render(c, WIDTH, HEIGHT))
        frames.append(img)
        frame_ms.append(ms)
    rk.update_light("sun", DirLight.create((0.1, 0.4, -0.9), 1.0))
    img, move_ms = host_ms(torch, lambda: rk.render(cams[0], WIDTH, HEIGHT))
    frames.append(img)
    launches = {n: k.launches for n, k in zip(names, kernels)}
    print(f"[slice] launches {launches} | rebuild {rebuild_ms:.2f} ms | "
          f"frames {', '.join(f'{m:.2f}' for m in frame_ms)} ms | light move "
          f"+ frame {move_ms:.2f} ms | {card}", flush=True)
    for n in names:
        check(launches[n] > 0, f"kernel {n} was not launched by the main path")
        results[n]["launches"] = launches[n]

    sums = []
    for f in frames:
        check(tuple(f.shape) == (HEIGHT, WIDTH, 4), f"frame shape {f.shape}")
        check(bool(torch.isfinite(f).all()), "non-finite frame")
        cover = float((f[..., 3] > 0.01).float().mean())
        check(cover > 0.05, f"alpha coverage {cover:.3f} too small")
        sums.append(float(f.double().sum()))
    check(len(set(sums)) == len(sums), f"frame checksums repeat: {sums}")

    rp = make_renderer()
    with all_plain():
        ref = rp.render(cams[0], WIDTH, HEIGHT)
    rk2 = make_renderer()
    got = rk2.render(cams[0], WIDTH, HEIGHT)
    frame_err = float((got - ref).abs().max())
    print(f"[slice] frame vs all-plain path on the card: max_abs_err "
          f"{frame_err:.3e} (limit {FRAME_VS_PLAIN_LIMIT:.0e}) | checksums "
          f"{', '.join(f'{s:.1f}' for s in sums)}", flush=True)
    check(frame_err <= FRAME_VS_PLAIN_LIMIT, "kernel frame != plain frame")
    del rp, rk2, ref, got, frames

    # Small scene: the card (bf16 planes) against the CPU path (float32).
    small = synthetic.ct_like_phantom((24, 24, 24), seed=0)
    imgs = []
    for d in (dev, torch.device("cpu")):
        r = Renderer(small, tf_table=T.tf_ct_bone(device=d),
                     windowing=windowing,
                     config=RendererConfig(step_count=20, jitter=True),
                     device=d)
        r.add_light("sun", light)
        imgs.append(r.render(cam, 64, 48).cpu())
    diff = (imgs[0] - imgs[1]).abs()
    print(f"[small] card vs CPU at 24^3, 64x48: mean {float(diff.mean()):.2e} "
          f"(limit {SMALL_MEAN_LIMIT:.0e}), max {float(diff.max()):.2e} "
          f"(limit {SMALL_MAX_LIMIT:.0e})", flush=True)
    check(float(diff.mean()) < SMALL_MEAN_LIMIT
          and float(diff.max()) < SMALL_MAX_LIMIT, "card != CPU on 24^3")
    torch.cuda.synchronize()

    # --- 5. fwd+bwd --------------------------------------------------------
    fwd_bwd_phase(torch, volume, cam, transform, clip, card, results)
    torch.cuda.synchronize()

    # --- 6. march ----------------------------------------------------------
    march_phase(torch, volume, tf, windowing, light, cam, transform, card,
                results)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
             **results[n]) for n, _, _ in kernel_table()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
