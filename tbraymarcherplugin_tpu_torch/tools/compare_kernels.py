"""Hold the kernels K1, K2, K4, K5, K6, K7, K8 and K9 of this checkout
against another checkout's build of them, on the main path's own inputs.

    python -m tbraymarcherplugin_tpu_torch.tools.compare_kernels OTHER

Run from the repository root: it takes the bench scene, the fwd+bwd step,
the kernel table and the timers from ``chip_smoke.py``. ``OTHER`` is the
root of another checkout (an earlier commit, unpacked with ``git
archive``); its ``tbraymarcherplugin_tpu_torch`` is imported under another
name and builds its kernels into its own ``_build/``. The inputs are those
of ``chip_smoke.py``'s phases 4 (lit K1 with jitter; K4 on the rebuild's
primary and secondary face), 5 (both warp passes' K2, K5, both warp
passes' K6 and the first face's K7 and K8 of the fused fwd+bwd step), 6
(K9 at the fly-through camera and at the bench camera forced to march;
this checkout's call keeps the occupancy grid the path gave it, the
other's goes without where its wrapper takes none) and 10 (K1's
intensity, unlit and λ-ceiling variants). For each kernel it prints
whether both builds give the same bits (K1's, K2's, K4's and K9's output;
K7's d opacity, sum m and m_0; K5's dW and dL, and the largest difference
of d TF and d window over their largest value, which sum in another
order; K6's d rows and K8's d values, d TF and d window, the largest
difference over the largest value where the bits differ, and for K8
whether this build gives the same bits on two runs), and the device time
of each (``chip_smoke.device_ms``), taken in turns: other, this, this,
other; for K2, K4 and K8 also the time of back-to-back calls
(``chip_smoke.cuda_ms``, which holds the host where the host is slower).
Then the peak device memory of one fused fwd+bwd step through each K5;
the fused step's host ms and device ms through each checkout's K2, K4, K6
and K8; the illumination rebuild (one light, two faces), a light move
(four faces) and the lit frame at the bench camera, host ms and device
ms, through each checkout's `Renderer`, in turns. Then the renderer at the
fly-through camera: a window drag, each frame after a new window center
(which rebuilds the illumination and, with empty-space skipping, the
occupancy grid), through the other checkout's renderer, this one's and
this one's without skipping, in turns; and this one's "blocked" march
with the grid at mip 1 and at mip 3, in turns, with each grid's build.
The last line is one JSON object of it all.
Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch


def load_other(root) -> dict:
    """kernel name -> (module, wrapper) of the checkout at ``root``,
    imported as the package ``other_port``."""
    pkg = Path(root).resolve() / "tbraymarcherplugin_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return {name: (importlib.import_module("other_port.ops." + mod), fn)
            for name, mod, fn in WRAPPERS}


# kernel name -> the module under ``ops`` and the wrapper that launches it
WRAPPERS = (("composite", "composite", "composite"),
            ("row_lerp", "warp", "row_lerp"),
            ("light_scan", "light_scan", "propagate_face_scan"),
            ("composite_bwd", "shearwarp_grad", "composite_bwd"),
            ("row_lerp_bwd", "warp", "row_lerp_bwd"),
            ("light_scan_bwd", "light_scan", "propagate_face_scan_bwd"),
            ("tf_alpha_bwd", "tf_alpha", "windowed_tf_alpha_bwd"),
            ("march", "fused_march", "march_lit_fused"))
# the kernels whose kernel ms (back-to-back calls) is printed beside their
# device ms
KERNEL_MS = ("light_scan", "tf_alpha_bwd", "row_lerp")
# the kernels of the fused fwd+bwd step swapped for the other checkout's
FUSED_SWAPS = ("row_lerp", "light_scan", "row_lerp_bwd", "tf_alpha_bwd")


# the window centers a drag alternates between, one per frame
DRAG_CENTERS = (0.5, 0.505)
BLOCKED_MIPS = (3, 1, 1, 3)


def renderer_phases(CS, dev, card) -> dict:
    """Device ms and host ms per fly-through frame under a window drag
    through the other checkout's renderer (``other_port``), this one's and
    this one's without empty-space skipping, in turns; device ms of this
    one's "blocked" march frame with the grid at each of BLOCKED_MIPS, and
    of that grid's build."""
    from .. import renderer as R
    from ..ops import octree as O
    from ..ops import synthetic

    volume = torch.from_numpy(synthetic.ct_like_phantom(CS.DIMS, seed=0)).to(
        dev)

    def make(pkg, **cfg):
        S = importlib.import_module(pkg + ".scene")
        Rm = importlib.import_module(pkg + ".renderer")
        T = importlib.import_module(pkg + ".ops.transfer")
        V = importlib.import_module(pkg + ".utils.volume_info")
        r = Rm.Renderer(volume, tf_table=T.tf_ct_bone(device=dev),
                        windowing=V.WindowingParameters(*CS.WINDOW),
                        transform=S.VolumeTransform.create(),
                        config=Rm.RendererConfig(step_count=CS.STEPS,
                                                 jitter=True, **cfg),
                        device=dev)
        r.add_light("sun", S.DirLight.create(CS.LIGHT_DIR, 1.0))
        cam = S.Camera.look_at(CS.FLY_POS, (0.0, 0.0, 0.0),
                               fov_degrees=CS.FLY_FOV)
        return r, cam

    def drag_frame(pkg, **cfg):
        r, cam = make(pkg, **cfg)
        n = itertools.count()

        def frame():
            r.set_window_center(DRAG_CENTERS[next(n) % 2])
            return r.render(cam, CS.WIDTH, CS.HEIGHT)
        return frame

    here = __package__.rsplit(".", 1)[0]
    variants = {"other": ("other_port", {}), "this": (here, {}),
                "this, no skipping": (here,
                                      dict(empty_space_skipping=False))}
    drag = {k: {"device_ms": [], "host_ms": []} for k in variants}
    for who in ("other", "this", "this, no skipping", "this, no skipping",
                "this", "other"):
        frame = drag_frame(variants[who][0], **variants[who][1])
        drag[who]["device_ms"].append(CS.device_ms(torch, frame, 3)[0])
        host = [CS.host_ms(torch, frame)[1] for _ in range(3)]
        drag[who]["host_ms"].append(sum(host) / len(host))
    for who, t in drag.items():
        print(f"[compare] fly-through frame under a window drag, {who}: "
              f"device ms {', '.join(f'{x:.4f}' for x in t['device_ms'])}, "
              f"host ms {', '.join(f'{x:.2f}' for x in t['host_ms'])} | "
              f"{card}", flush=True)

    blocked = {m: {"frame_device_ms": [], "grid_device_ms": []}
               for m in set(BLOCKED_MIPS)}
    for mip in BLOCKED_MIPS:
        with mock.patch.object(R, "OCCUPANCY_MIP", mip):
            r, cam = make(here, march_impl="blocked")
            occ = r.occupancy()
            win = r.windowing.as_vec4(dev)
            blocked[mip]["frame_device_ms"].append(CS.device_ms(
                torch, lambda: r.render(cam, CS.WIDTH, CS.HEIGHT), 2)[0])
            blocked[mip]["grid_device_ms"].append(CS.device_ms(
                torch, lambda: O.occupancy_grid(r.octree, win, r.tf_table,
                                                mip=mip), 3)[0])
            blocked[mip]["occupied"] = float(occ.grid.float().mean())
        del r
    for mip, t in sorted(blocked.items()):
        print(f"[compare] blocked march frame, grid at mip {mip} "
              f"({t['occupied']:.3f} occupied): device ms "
              f"{', '.join(f'{x:.3f}' for x in t['frame_device_ms'])}; the "
              f"grid's build "
              f"{', '.join(f'{x:.4f}' for x in t['grid_device_ms'])} | "
              f"{card}", flush=True)
    return dict(fly_through_drag=drag,
                blocked_march={str(m): t for m, t in blocked.items()})


def fused_step_turns(CS, step, mine, other, card) -> dict:
    """Host ms and device ms of the fused fwd+bwd step through this
    checkout's K2, K4, K6 and K8 and through the other's, in turns."""
    out = {"this": {"host_ms": [], "device_ms": []},
           "other": {"host_ms": [], "device_ms": []}}
    for who in ("other", "this", "this", "other"):
        with contextlib.ExitStack() as stack:
            if who == "other":
                for name in FUSED_SWAPS:
                    (mod, fn), (omod, ofn) = mine[name], other[name]
                    stack.enter_context(
                        mock.patch.object(mod, fn, getattr(omod, ofn)))
            step(CS.FWD_BWD_CENTERS[1])
            host = [CS.host_ms(torch, lambda c=c: step(c))[1]
                    for c in CS.FWD_BWD_CENTERS]
            out[who]["host_ms"].append(sum(host) / len(host))
            out[who]["device_ms"].append(CS.device_ms(
                torch, lambda: step(CS.FWD_BWD_CENTERS[2]), 2)[0])
    for who, t in out.items():
        print(f"[compare] fused fwd+bwd step through {who} K2, K4, K6 and "
              f"K8: host "
              f"ms {', '.join(f'{x:.2f}' for x in t['host_ms'])}, device "
              f"ms {', '.join(f'{x:.3f}' for x in t['device_ms'])} | {card}",
              flush=True)
    return out


MOVED_LIGHT = (0.1, 0.4, -0.9)


def lighting_turns(CS, dev, card) -> dict:
    """Host ms and device ms of the illumination rebuild (one light, after
    a new window center), of a light move (the light swapped between two
    directions: four faces) and of the lit frame at the bench camera
    (illumination built) through the other checkout's `Renderer` and this
    one's, in turns."""
    from ..ops import synthetic

    volume = torch.from_numpy(synthetic.ct_like_phantom(CS.DIMS, seed=0)).to(
        dev)
    here = __package__.rsplit(".", 1)[0]

    def make(pkg):
        S = importlib.import_module(pkg + ".scene")
        Rm = importlib.import_module(pkg + ".renderer")
        T = importlib.import_module(pkg + ".ops.transfer")
        V = importlib.import_module(pkg + ".utils.volume_info")
        r = Rm.Renderer(volume, tf_table=T.tf_ct_bone(device=dev),
                        windowing=V.WindowingParameters(*CS.WINDOW),
                        transform=S.VolumeTransform.create(),
                        config=Rm.RendererConfig(step_count=CS.STEPS,
                                                 jitter=True),
                        device=dev)
        r.add_light("sun", S.DirLight.create(CS.LIGHT_DIR, 1.0))
        r.ensure_lighting()
        n_rebuild, n_move = itertools.count(), itertools.count()

        def rebuild():
            r.set_window_center(DRAG_CENTERS[next(n_rebuild) % 2])
            r.ensure_lighting()

        def move():  # starts from CS.LIGHT_DIR: every call moves it
            d = (MOVED_LIGHT, CS.LIGHT_DIR)[next(n_move) % 2]
            r.update_light("sun", S.DirLight.create(d, 1.0))
            r.ensure_lighting()
        cam = S.Camera.look_at(CS.CAM_POS, 0.0, fov_degrees=CS.FOV)

        def frame():
            return r.render(cam, CS.WIDTH, CS.HEIGHT)
        return {"rebuild": rebuild, "light move": move, "lit frame": frame}

    out = {}
    for who in ("other", "this", "this", "other"):
        fns = make("other_port" if who == "other" else here)
        fns["lit frame"]()  # the grid and the light of its second frame on
        for what, fn in fns.items():
            host = [CS.host_ms(torch, fn)[1] for _ in range(4)]
            t = out.setdefault(what, {}).setdefault(
                who, {"host_ms": [], "device_ms": []})
            t["host_ms"].append(sum(host) / len(host))
            t["device_ms"].append(CS.device_ms(torch, fn, 4)[0])
    for what, per in out.items():
        for who, t in per.items():
            print(f"[compare] {what} through {who} renderer: host ms "
                  f"{', '.join(f'{x:.2f}' for x in t['host_ms'])}, device "
                  f"ms {', '.join(f'{x:.3f}' for x in t['device_ms'])} | "
                  f"{card}", flush=True)
    return {"lighting": out}


def path_inputs(CS, dev) -> dict:
    """name -> (args, kwargs) of the K1, K4, K5, K6, K7 and K9 calls of
    chip_smoke's phases 4, 5, 6 and 10 at the bench scene."""
    from ..ops import composite as K1
    from ..ops import lighting as Lt
    from ..ops import shearwarp as SW
    from ..ops import synthetic
    from ..ops import transfer as T
    from ..ops.rays import jitter_values, scene_depth_from_plane
    from ..renderer import Renderer, RendererConfig
    from ..scene import (Camera, ClipPlane, DirLight, VolumeTransform,
                         orbit_camera)
    from ..utils.volume_info import WindowingParameters

    volume = torch.from_numpy(synthetic.ct_like_phantom(CS.DIMS, seed=0)).to(
        dev)
    tf = T.tf_ct_bone(device=dev)
    windowing = WindowingParameters(*CS.WINDOW)
    win = windowing.as_vec4(dev)
    transform = VolumeTransform.create()
    clip = transform.local_clip_plane(ClipPlane.disabled())
    light = DirLight.create(CS.LIGHT_DIR, 1.0)
    cam = Camera.look_at(CS.CAM_POS, 0.0, fov_degrees=CS.FOV)
    calls = {}

    # phase 4: the lit frame's K1 call
    local_dir = transform.local_light_direction(light)
    light_volume = Lt.reset_all_lights(volume, tf, win, clip.center,
                                       clip.direction, [(local_dir, 1.0)],
                                       CS.DIMS)
    plan = SW.plan_shearwarp(cam, transform, CS.DIMS, CS.DIMS, CS.WIDTH,
                             CS.HEIGHT, max_planes=CS.STEPS)
    jit = jitter_values(plan.n2, plan.n1, 0, device=dev)
    calls["composite"] = ((), K1.prepare_composite(
        volume, tf, light_volume, plan, win, clip.center, clip.direction,
        jitter=jit))

    # phase 4: K4 on the rebuild's primary and secondary face
    r = Renderer(volume, tf_table=tf, windowing=windowing,
                 transform=transform,
                 config=RendererConfig(step_count=CS.STEPS, jitter=True),
                 device=dev)
    r.add_light("sun", light)
    got = {}
    with CS.capture_calls(got, ["light_scan"]):
        r.ensure_lighting()
    calls["light_scan"], calls["light_scan_secondary"] = got["light_scan"]

    # phase 5: both passes' K2, K5, both passes' K6 and the first face's K7
    # and K8 of a fused fwd+bwd step
    step = CS.make_fwd_bwd_step(
        torch, volume, cam, transform, clip, CS.WIDTH, CS.HEIGHT,
        dict(march_impl="shearwarp", shearwarp_tf_unit="fused",
             shearwarp_dtype=None), max_planes=CS.STEPS)
    got = {}
    with CS.capture_calls(got, ["row_lerp", "composite_bwd",
                                "light_scan_bwd", "row_lerp_bwd",
                                "tf_alpha_bwd"]):
        step(CS.FWD_BWD_CENTERS[0])
    calls["row_lerp_pass1"], calls["row_lerp_pass2"] = got["row_lerp"]
    calls["composite_bwd"] = got["composite_bwd"][0]
    calls["light_scan_bwd"] = got["light_scan_bwd"][0]
    calls["tf_alpha_bwd"] = got["tf_alpha_bwd"][0]
    # the backward takes the screen pass first
    calls["row_lerp_bwd_pass2"], calls["row_lerp_bwd_pass1"] = (
        got["row_lerp_bwd"])

    # phase 6: K9 at the fly-through camera and at the bench camera forced
    # to march
    fly = Camera.look_at(CS.FLY_POS, (0.0, 0.0, 0.0),
                         fov_degrees=CS.FLY_FOV)
    for name, c, impl in (("march", fly, "auto"),
                          ("march_bench_camera", cam, "pallas")):
        r = Renderer(volume, tf_table=tf, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=CS.STEPS, jitter=True,
                                           march_impl=impl), device=dev)
        r.add_light("sun", light)
        r.occupancy()  # the grid of its second frame on
        got = {}
        with CS.capture_calls(got, ["march"]):
            r.render(c, CS.WIDTH, CS.HEIGHT)
        calls[name] = got["march"][0]

    # phase 10: the intensity, octree and λ-ceiling frames' K1 calls
    radius = math.hypot(CS.CAM_POS[0], CS.CAM_POS[1])
    angle0 = math.atan2(CS.CAM_POS[1], CS.CAM_POS[0])
    cam0 = orbit_camera(angle0, radius, CS.CAM_POS[2], fov_degrees=CS.FOV)
    depth = scene_depth_from_plane(cam0, transform, CS.WIDTH, CS.HEIGHT,
                                   *CS.DEPTH_PLANE, device=dev)
    for mode, name, kw in (("intensity", "composite_intensity", {}),
                           ("octree", "composite_unlit", {}),
                           ("lit", "composite_depth",
                            dict(scene_depth=depth))):
        r = Renderer(volume, tf_table=tf, windowing=windowing,
                     transform=transform,
                     config=RendererConfig(step_count=CS.STEPS, jitter=True,
                                           render_mode=mode), device=dev)
        r.add_light("sun", light)
        got = {}
        with CS.capture_calls(got, ["composite"]):
            r.render(cam0, CS.WIDTH, CS.HEIGHT, **kw)
        calls[name] = got["composite"][0]
    return calls, step


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as CS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    other = load_other(argv[0])
    mine = {name: (importlib.import_module(
        f"tbraymarcherplugin_tpu_torch.ops.{mod}"), fn)
        for name, mod, fn in WRAPPERS}
    calls, step = path_inputs(CS, dev)
    result = {}
    with torch.no_grad():
        for name, (args, kw) in calls.items():
            kernel = max((k for k in mine
                          if name == k or name.startswith(k + "_")), key=len)
            (mod, fn), (omod, ofn) = mine[kernel], other[kernel]
            this_fn, other_fn = getattr(mod, fn), getattr(omod, ofn)
            okw = dict(kw)
            if (kernel == "march" and "occupancy" not in
                    inspect.signature(other_fn).parameters):
                okw.pop("occupancy", None)
            a, b = this_fn(*args, **kw), other_fn(*args, **okw)
            if kernel == "composite_bwd":
                same = all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
                rel = max(float((x - y).abs().max() / y.abs().max())
                          for x, y in zip(a[2:], b[2:]))
            elif kernel == "light_scan_bwd":
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                rel = max(float((x - y).abs().max()) for x, y in zip(a, b))
            elif kernel == "row_lerp_bwd":
                same = torch.equal(a, b)
                rel = float((a - b).abs().max() / b.abs().max())
            elif kernel == "tf_alpha_bwd":
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                rel = max(float((x - y).abs().max() / y.abs().max())
                          for x, y in zip(a, b) if y.any())
                again = this_fn(*args, **kw)
                repeat = all(torch.equal(x, y) for x, y in zip(a, again))
                del again
            else:
                same, rel = torch.equal(a, b), float((a - b).abs().max())
            del a, b
            times = {"other": [], "this": []}
            kernel_ms = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                f, k = (this_fn, kw) if who == "this" else (other_fn, okw)
                times[who].append(CS.device_ms(
                    torch, lambda f=f, k=k: f(*args, **k), 5)[0])
                if kernel in KERNEL_MS:
                    kernel_ms[who].append(CS.cuda_ms(
                        torch, lambda f=f, k=k: f(*args, **k), 10))
            result[name] = dict(same_bits=same, other_diff=rel,
                                device_ms=times["this"],
                                other_device_ms=times["other"])
            what = {"composite_bwd": "d TF, d window relative",
                    "row_lerp_bwd": "relative",
                    "tf_alpha_bwd": "relative"}.get(kernel, "max abs")
            if kernel == "tf_alpha_bwd":
                result[name]["same_bits_run_to_run"] = repeat
                what += f"; this build's bits on two runs equal {repeat}"
            line = (f"device ms this "
                    f"{', '.join(f'{t:.4f}' for t in times['this'])}, other "
                    f"{', '.join(f'{t:.4f}' for t in times['other'])}")
            if kernel_ms["this"]:
                result[name].update(kernel_ms=kernel_ms["this"],
                                    other_kernel_ms=kernel_ms["other"])
                line += (f"; kernel ms this "
                         f"{', '.join(f'{t:.4f}' for t in kernel_ms['this'])}"
                         f", other "
                         f"{', '.join(f'{t:.4f}' for t in kernel_ms['other'])}")
            print(f"[compare] {name}: same bits as the other build {same} "
                  f"({what} difference {rel:.3e}) | {line} | {card}",
                  flush=True)
    del calls
    peaks = {}
    K5 = mine["composite_bwd"][0]
    o5 = other["composite_bwd"][0]
    for who in ("other", "this", "this", "other"):
        swap = (mock.patch.object(K5, "composite_bwd", o5.composite_bwd)
                if who == "other" else contextlib.nullcontext())
        with swap:
            step(CS.FWD_BWD_CENTERS[1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(CS.FWD_BWD_CENTERS[2])
            torch.cuda.synchronize()
        peaks.setdefault(who, []).append(
            torch.cuda.max_memory_allocated() / 2**20)
    result["fused_step_peak_mib"] = dict(this=peaks["this"],
                                         other=peaks["other"])
    print(f"[compare] fused fwd+bwd step, peak device memory (MiB): this "
          f"{peaks['this']}, other K5 {peaks['other']} | {card}", flush=True)
    result["fused_step_k4_k6"] = fused_step_turns(CS, step, mine, other, card)
    del step
    with torch.no_grad():
        result.update(lighting_turns(CS, dev, card))
    with torch.no_grad():
        result.update(renderer_phases(CS, dev, card))
    print(json.dumps(dict(card=card, **result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
