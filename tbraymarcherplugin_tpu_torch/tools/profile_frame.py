"""Where the time of a lit frame, an illumination rebuild, a light move,
differentiable fwd+bwd steps, a fit step and a fly-through frame goes on
one CUDA device.

    python -m tbraymarcherplugin_tpu_torch.tools.profile_frame

Builds the bench scene (256^3 `ct_like_phantom(seed=0)`, bone TF, window
(0.5, 0.8), one light at (0.3, 0.1, -0.95), camera
`look_at((0.1, -2.3, 0.4), 0)` at 40 degrees, 1920x1080, 150 planes,
jitter on) through `Renderer`, and the same scene without jitter through
`models.pipeline.render_lit_scene` for ``fwd_bwd`` (the fused composite,
``shearwarp_tf_unit="fused"``, bf16 planes) and ``dense_fwd_bwd`` (the
dense composite with the ``"pallas"`` TF unit, kernels K10a/K10b): one
``loss.backward()`` of the L2 loss against the frame at window
(0.5, 0.8), the window center moving by 0.01 per call from 0.55; for
``fit_step`` one step of `models.fitting.fit` (``march_impl="shearwarp"``,
the dense composite with its default "xla" TF unit, TF and window
trained) from window center 0.6 toward that frame; and for
``fly_through`` the same scene from a camera inside the volume
(`look_at((0.1, -0.3, 0.05), 0)` at 60 degrees), where shear-warp has no
plan and the frame is the ray march (kernel K9). It warms every phase up
once, then times and profiles ``REPS`` calls of each phase and prints:

- ``wall``: host-clock ms per call without the profiler, work ended by
  ``torch.cuda.synchronize()``;
- under ``torch.profiler``: wall ms per call, device-busy ms per call (the
  union of the kernel, memcpy and memset intervals of the trace) and the
  device's idle share, 1 - busy / wall;
- the ``TOP`` device-time consumers per call. A kernel launched by a torch
  operator is named after that operator (the innermost ``aten::`` op the
  trace links it to); the port's own kernels, launched through ctypes, keep
  their kernel names.

The last line is one JSON object of those numbers. Needs a CUDA device;
exits with code 2 without one.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

DIMS = (256, 256, 256)
WIDTH, HEIGHT, STEPS = 1920, 1080, 150
WINDOW = (0.5, 0.8)
LIGHT_DIRS = ((0.3, 0.1, -0.95), (0.1, 0.4, -0.9))
CAM_POS = (0.1, -2.3, 0.4)
FOV = 40.0
FLY_POS, FLY_FOV = (0.1, -0.3, 0.05), 60.0
REPS, TOP = 5, 12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _short(name: str, n: int = 72) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    depth, out = 0, []
    for ch in name:  # drop template arguments
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    name = "".join(out)
    return name if len(name) <= n else name[: n - 3] + "..."


def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_breakdown(trace: dict):
    """(busy us, {name: (device us, launches)}) of a Chrome trace."""
    events = trace.get("traceEvents", [])
    ops = {}
    for ev in events:
        if ev.get("cat") == "cpu_op":
            ext = ev.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = ev.get("name", "?")
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        spans.append((ts, ts + dur))
        ext = ev.get("args", {}).get("External id")
        name = ops.get(ext) or _short(ev.get("name", "?"))
        by_name[name][0] += dur
        by_name[name][1] += 1
    return _busy_us(spans), by_name


def profile_phase(fn, reps: int, trace_path: str):
    """(profiled wall ms per call, busy ms per call, {name: (ms, n) per
    call}) of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        busy_us, by_name = device_breakdown(json.load(f))
    per_call = {k: (v[0] / 1e3 / reps, v[1] / reps)
                for k, v in by_name.items()}
    return wall, busy_us / 1e3 / reps, per_call


def wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2

    from ..models import pipeline as PP
    from ..models.fitting import FitConfig, fit
    from ..ops import shearwarp as SW
    from ..ops import synthetic
    from ..ops import transfer as T
    from ..ops.rays import setup_rays
    from ..renderer import Renderer, RendererConfig
    from ..scene import Camera, ClipPlane, DirLight, VolumeTransform
    from ..utils.volume_info import WindowingParameters

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    volume = torch.from_numpy(synthetic.ct_like_phantom(DIMS, seed=0)).to(dev)

    def make_renderer():
        rend = Renderer(volume, tf_table=T.tf_ct_bone(device=dev),
                        windowing=WindowingParameters(*WINDOW),
                        config=RendererConfig(step_count=STEPS, jitter=True),
                        device=dev)
        rend.add_light("sun", DirLight.create(LIGHT_DIRS[0], 1.0))
        return rend

    r, r_fly = make_renderer(), make_renderer()
    cam = Camera.look_at(CAM_POS, 0.0, fov_degrees=FOV)
    fly_cam = Camera.look_at(FLY_POS, 0.0, fov_degrees=FLY_FOV)
    moves = [0]

    def rebuild():
        r.set_window_center(WINDOW[0])  # dirties the illumination
        r.ensure_lighting()

    def frame():
        r.render(cam, WIDTH, HEIGHT)

    def fly_through():
        r_fly.render(fly_cam, WIDTH, HEIGHT)

    def light_move():
        moves[0] += 1
        r.update_light("sun", DirLight.create(LIGHT_DIRS[moves[0] % 2], 1.0))
        r.ensure_lighting()

    transform = VolumeTransform.create()
    clip = ClipPlane.disabled()
    plan = SW.plan_shearwarp(cam, transform, DIMS, DIMS, WIDTH, HEIGHT,
                             max_planes=STEPS)
    rays = setup_rays(cam, transform, WIDTH, HEIGHT)
    light_plans = (PP.LightPlan.create(LIGHT_DIRS[0], DIMS),)

    def params(center):
        return PP.RenderParams(
            volume.detach(), T.tf_ct_bone(device=dev),
            torch.tensor(center, device=dev),
            torch.tensor(WINDOW[1], device=dev),
            torch.tensor([1.0], device=dev))

    def render(p, tf_unit="fused"):
        return PP.render_lit_scene(
            p, rays, clip.center, clip.direction, light_plans, DIMS,
            march_impl="shearwarp", shearwarp_plan=plan,
            shearwarp_tf_unit=tf_unit,
            shearwarp_dtype=(torch.bfloat16 if tf_unit == "fused"
                             else torch.float32))

    with torch.no_grad():
        target = render(params(WINDOW[0]))
    steps = [0]

    def step(tf_unit):
        steps[0] += 1
        p = params(0.55 + 0.01 * (steps[0] % 3))
        for t in (p.volume, p.tf_table, p.window_center, p.window_width,
                  p.light_intensities):
            t.requires_grad_()
        ((render(p, tf_unit) - target) ** 2).mean().backward()

    fit_cfg = FitConfig(steps=1, march_impl="shearwarp", shearwarp_plan=plan)

    def fit_step():
        fit(params(0.6), rays, target, clip.center, clip.direction,
            light_plans, DIMS, fit_cfg)

    phases = (("rebuild", rebuild), ("frame", frame),
              ("light_move", light_move),
              ("fwd_bwd", lambda: step("fused")),
              ("dense_fwd_bwd", lambda: step("pallas")),
              ("fit_step", fit_step), ("fly_through", fly_through))
    for _, fn in phases:  # build the kernels, the plan and the caches
        fn()
    print(f"[profile] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {REPS} "
          f"calls per phase", flush=True)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in phases:
            plain_wall = wall_ms(fn, REPS)
            wall, busy, per_call = profile_phase(
                fn, REPS, os.path.join(tmp, f"{name}.json"))
            idle = 1.0 - busy / wall if wall > 0 else float("nan")
            print(f"[{name}] wall {plain_wall:.3f} ms | profiled wall "
                  f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                  f"{idle:.3f} | {card}", flush=True)
            if busy == 0.0:
                print(f"[{name}] the trace holds no device activity",
                      flush=True)
            top = sorted(per_call.items(), key=lambda kv: -kv[1][0])
            for op, (ms, n) in top[:TOP]:
                print(f"    {ms:9.3f} ms  {n:7.1f} launches  {op}")
            summary[name] = dict(
                wall_ms=plain_wall, profiled_wall_ms=wall, busy_ms=busy,
                idle_share=idle,
                top=[dict(name=op, ms=ms, launches=n)
                     for op, (ms, n) in top[:TOP]])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "phases": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
