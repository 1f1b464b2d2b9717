"""K4's launch plans at the main path's inputs: the device time of each
plan, in turns.

    python -m tbraymarcherplugin_tpu_torch.tools.sweep_scans

Run from the repository root: it takes the bench scene and the timers from
``chip_smoke.py``. K4 runs on the illumination rebuild's primary and
secondary face (256^3, one light) with T = 1 unstaged (taps from L2),
T = 1, 2, 4, 8 and 16 staged in units of 4 pixels, and T = 4 and 8 in
units of 1 pixel, each plan forced with ``scan_plan``'s overrides and
launched with ``light_scan._launch_scan``; each must give the default
plan's bits, and prints its device ms and kernel ms
(``chip_smoke.device_ms``, ``chip_smoke.cuda_ms``). The plans of one face
are timed in turns (each, then each in reverse). The last line is one JSON
object. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

K4_VARIANTS = (("T1 unstaged", dict(slices=1, staged=False)),
               ("T1", dict(slices=1)), ("T2", dict(slices=2)),
               ("T4", dict(slices=4)), ("T8", dict(slices=8)),
               ("T16", dict(slices=16)), ("T4 units of 1", dict(slices=4,
                                                                vec=1)),
               ("T8 units of 1", dict(slices=8, vec=1)))


def in_turns(CS, fns: dict, reps: int, kernel_ms: bool) -> dict:
    """name -> [device ms, ...] (and kernel ms) of each ``fns`` entry,
    timed in turns: each in order, then each in reverse."""
    out = {name: {"device_ms": []} for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name]["device_ms"].append(CS.device_ms(torch, fns[name], reps)[0])
        if kernel_ms:
            out[name].setdefault("kernel_ms", []).append(
                CS.cuda_ms(torch, fns[name], 2 * reps))
    return out


def rebuild_faces(CS, dev):
    """The (args, kwargs) of the rebuild's two K4 calls (the autograd
    function passes its four arguments by position)."""
    from ..ops import synthetic
    from ..ops import transfer as T
    from ..renderer import Renderer, RendererConfig
    from ..scene import DirLight, VolumeTransform
    from ..utils.volume_info import WindowingParameters

    volume = torch.from_numpy(synthetic.ct_like_phantom(CS.DIMS, seed=0)).to(
        dev)
    r = Renderer(volume, tf_table=T.tf_ct_bone(device=dev),
                 windowing=WindowingParameters(*CS.WINDOW),
                 transform=VolumeTransform.create(),
                 config=RendererConfig(step_count=CS.STEPS, jitter=True),
                 device=dev)
    r.add_light("sun", DirLight.create(CS.LIGHT_DIR, 1.0))
    calls = {}
    with CS.capture_calls(calls, ["light_scan"]), torch.no_grad():
        r.ensure_lighting()
    return calls["light_scan"]


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_scans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as CS

    from ..ops import light_scan as K4

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "light_scan": {}}
    with torch.no_grad():
        faces = zip(("primary", "secondary"), rebuild_faces(CS, dev))
        for face, ((op, off_px, off_py, alpha), _) in faces:
            op = op.contiguous()
            want = K4.propagate_face_scan(op, off_px, off_py, alpha)
            fns = {}
            for name, forced in K4_VARIANTS:
                plan = K4.scan_plan(*op.shape, off_px,
                                    *K4.device_limits(dev), **forced)
                run = (lambda plan=plan: K4._launch_scan(
                    op, plan, off_px, off_py, alpha))
                if not torch.equal(run(), want):
                    raise AssertionError(f"K4 {name} != the default plan")
                fns[name] = run
            res = result["light_scan"][face] = in_turns(CS, fns, 5, True)
            for name, t in res.items():
                print(f"[sweep] K4 {face} face, {name}: device ms "
                      f"{', '.join(f'{x:.4f}' for x in t['device_ms'])}; "
                      f"kernel ms "
                      f"{', '.join(f'{x:.4f}' for x in t['kernel_ms'])} | "
                      f"{card}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
