"""Hold the composite kernels K1 and K5 of this checkout against another
checkout's build of them, on the main path's own inputs.

    python -m tbraymarcherplugin_tpu_torch.tools.compare_kernels OTHER

Run from the repository root: it takes the bench scene, the fwd+bwd step,
the kernel table and the timers from ``chip_smoke.py``. ``OTHER`` is the
root of another checkout (an earlier commit, unpacked with ``git
archive``); its ``tbraymarcherplugin_tpu_torch`` is imported under another
name and builds its kernels into its own ``_build/``. The inputs are those
of ``chip_smoke.py``'s phases 4 (lit K1 with jitter), 5 (K5 of the fused
fwd+bwd step) and 10 (K1's intensity, unlit and λ-ceiling variants). For
each kernel it prints whether both builds give the same bits (K1's output;
K5's dW and dL, and the largest difference of d TF and d window over
their largest value, which sum in another order), and the device time of
each (``chip_smoke.device_ms``), taken in turns: other, this, this, other.
Then the peak device memory of one fused fwd+bwd step through each K5.
The last line is one JSON object of it all. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch


def load_other(root) -> tuple:
    """The ``ops.composite`` and ``ops.shearwarp_grad`` modules of the
    checkout at ``root``, imported as the package ``other_port``."""
    pkg = Path(root).resolve() / "tbraymarcherplugin_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("other_port.ops.composite"),
            importlib.import_module("other_port.ops.shearwarp_grad"))


def path_inputs(CS, dev) -> dict:
    """name -> (args, kwargs) of the K1 and K5 calls of chip_smoke's phases
    4, 5 and 10 at the bench scene."""
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

    # phase 5: K5 of a fused fwd+bwd step
    step = CS.make_fwd_bwd_step(
        torch, volume, cam, transform, clip, CS.WIDTH, CS.HEIGHT,
        dict(march_impl="shearwarp", shearwarp_tf_unit="fused",
             shearwarp_dtype=None), max_planes=CS.STEPS)
    got = {}
    with CS.capture_calls(got, ["composite_bwd"]):
        step(CS.FWD_BWD_CENTERS[0])
    calls["composite_bwd"] = got["composite_bwd"][0]

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

    from ..ops import composite as K1
    from ..ops import shearwarp_grad as K5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    o1, o5 = load_other(argv[0])
    calls, step = path_inputs(CS, dev)
    result = {}
    with torch.no_grad():
        for name, (args, kw) in calls.items():
            mine, other = ((K5.composite_bwd, o5.composite_bwd)
                           if name == "composite_bwd"
                           else (K1.composite, o1.composite))
            a, b = mine(*args, **kw), other(*args, **kw)
            if name == "composite_bwd":
                same = all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
                rel = max(float((x - y).abs().max() / y.abs().max())
                          for x, y in zip(a[2:], b[2:]))
            else:
                same, rel = torch.equal(a, b), float((a - b).abs().max())
            del a, b
            times = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                fn = mine if who == "this" else other
                times[who].append(CS.device_ms(
                    torch, lambda fn=fn: fn(*args, **kw), 5)[0])
            result[name] = dict(same_bits=same, other_diff=rel,
                                device_ms=times["this"],
                                other_device_ms=times["other"])
            what = ("d TF, d window relative" if name == "composite_bwd"
                    else "max abs")
            print(f"[compare] {name}: same bits as the other build {same} "
                  f"({what} difference {rel:.3e}) | device ms this "
                  f"{', '.join(f'{t:.4f}' for t in times['this'])}, other "
                  f"{', '.join(f'{t:.4f}' for t in times['other'])} | {card}",
                  flush=True)
    del calls
    peaks = {}
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
    print(json.dumps(dict(card=card, **result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
