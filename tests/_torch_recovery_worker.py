"""Worker of `tests/test_torch_recovery.py` (run as a subprocess; imports
no JAX).

Runs a small fit of the port with a checkpoint after every step. With
RECOVERY_KILL_AFTER set, the process hard-exits (``os._exit(17)``: no
cleanup, as a crash) right after that step's checkpoint lands. With
RECOVERY_RESUME=1 it restarts from the newest checkpoint. Each step's loss
is appended to RECOVERY_OUT.
"""

import os
import sys

sys.modules["jax"] = None  # any `import jax` raises ImportError
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tbraymarcherplugin_tpu_torch.models import fitting  # noqa: E402
from tbraymarcherplugin_tpu_torch.models.pipeline import (  # noqa: E402
    LightPlan, RenderParams,
)
from tbraymarcherplugin_tpu_torch.ops import synthetic  # noqa: E402
from tbraymarcherplugin_tpu_torch.ops import transfer as T  # noqa: E402
from tbraymarcherplugin_tpu_torch.ops.rays import setup_rays  # noqa: E402
from tbraymarcherplugin_tpu_torch.scene import (  # noqa: E402
    Camera, ClipPlane, VolumeTransform,
)


def main():
    ckpt_dir = os.environ["RECOVERY_CKPT"]
    out_path = os.environ["RECOVERY_OUT"]
    kill_after = int(os.environ.get("RECOVERY_KILL_AFTER", "-1"))
    resume = os.environ.get("RECOVERY_RESUME") == "1"
    torch.set_num_threads(1)

    dims = (12, 12, 12)
    params = RenderParams(
        volume=torch.from_numpy(synthetic.sphere_volume(dims, radius=0.35)),
        tf_table=T.default_grayscale_tf(),
        window_center=torch.tensor(0.45),
        window_width=torch.tensor(1.1),
        light_intensities=torch.tensor([1.0]),
    )
    cam = Camera.look_at([0.2, -2.4, 0.3], [0, 0, 0], fov_degrees=35.0)
    rays = setup_rays(cam, VolumeTransform.create(), 12, 12)
    plans = (LightPlan.create([0.3, 0.1, -0.95], dims),)
    clip = ClipPlane.disabled()
    target = torch.zeros(tuple(rays.thickness.shape) + (4,))

    def on_step(step, _params, loss):
        with open(out_path, "a") as f:
            f.write(f"{step} {loss:.10e}\n")
        if step == kill_after:
            with open(out_path, "a") as f:
                f.write("KILLED\n")
            os._exit(17)  # a crash: no atexit, no cleanup

    cfg = fitting.FitConfig(steps=7, step_count=8, optimize_tf=True,
                            optimize_window=True, learning_rate=5e-2)
    fitting.fit(params, rays, target, clip.center, clip.direction, plans,
                dims, config=cfg, callback=on_step, checkpoint_dir=ckpt_dir,
                checkpoint_every=1, resume=resume)
    assert "jax" not in sys.modules or sys.modules["jax"] is None


if __name__ == "__main__":
    main()
