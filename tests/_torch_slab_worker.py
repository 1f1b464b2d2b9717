"""One rank of the slab-sharded `Renderer` on the CPU over gloo, for
tests/test_torch_slab_renderer.py. It imports no JAX.

    RANK=r WORLD_SIZE=n COORD=file:///tmp/store \
        python tests/_torch_slab_worker.py out.npz

Each rank makes its own Z slab of the benchmark's Richtmyer-Meshkov
stand-in (`rmbench/volumes/rm_mixing.py`, at :data:`DIMS`), and for each
case of :data:`CASES` builds a sharded `Renderer` from it, renders a frame,
then one after a clip plane is set and one after the window center is
set (each a rebuild). Rank 0 writes every frame, every light volume (the
ranks' chunks gathered in rank order), the largest tensor any rank's
renderer held, and whether each rank refused a slab of the wrong shape.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIMS = (32, 24, 32)
SEED = 2**31 + 11
SIZE = (48, 32)
STEPS = 24
WINDOW = (0.55, 0.7)
CLIP = ((0.0, 0.05, 0.02), (0.3, -0.8, 0.52))
CENTER = 0.5  # the window center the third frame sets
# name: (camera position, lights as (direction, intensity), clip plane
# from the first frame, jitter); the principal axis is the camera's
# largest component
CASES = {
    # X axis; the light's Z face runs down Z (the ring from the top rank),
    # its second face X
    "axis_x": ((2.3, 0.6, 0.5), (((0.3, 0.1, -0.95), 1.0),), False, True),
    # Y axis; a Z face that runs up Z (the ring from rank 0) and a Y face
    "axis_y": ((0.4, -2.4, 0.7), (((0.2, 0.3, 0.93), 1.0),), False, True),
    # Z axis (the planes are Z slices), clipped from the start, no jitter
    "axis_z": ((0.3, 0.5, 2.4), (((-0.4, 0.5, 0.75), 1.0),), True, False),
    # the light mostly along X: an X face and a Y face, no Z face
    "xy_faces": ((0.5, 2.3, -0.6), (((-0.9, 0.3, 0.3), 1.0),), False,
                 True),
    # two lights: each light's faces sum into its contribution first, as
    # the one-card Renderer adds a light at a time
    "two_lights": ((-1.8, 1.4, 0.9), (((0.3, 0.1, -0.95), 1.0),
                                      ((-0.9, 0.3, 0.3), 0.6)), False, True),
}


def main(out_path):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from rmbench.reference.common import tf_table
    from rmbench.volumes import rm_mixing
    from tbraymarcherplugin_tpu_torch.parallel import distributed as D
    from tbraymarcherplugin_tpu_torch.parallel import mesh as PM
    from tbraymarcherplugin_tpu_torch.renderer import (Renderer,
                                                       RendererConfig)
    from tbraymarcherplugin_tpu_torch.scene import (Camera, ClipPlane,
                                                    DirLight)
    from tbraymarcherplugin_tpu_torch.utils.volume_info import (
        WindowingParameters)

    torch.set_num_threads(1)
    D.initialize_multihost(os.environ["COORD"], device="cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = PM.make_mesh({"slab": world})
    zc = DIMS[2] // world
    slab = rm_mixing.make(DIMS, SEED, "cpu", z=(rank * zc, (rank + 1) * zc))
    table = tf_table("ct_soft_tissue")
    out, largest = {}, 0

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=2).numpy()

    for name, (cam, lights, clipped, jitter) in CASES.items():
        r = Renderer(slab.clone(), tf_table=table,
                     windowing=WindowingParameters(*WINDOW),
                     config=RendererConfig(step_count=STEPS, jitter=jitter),
                     device="cpu", mesh=mesh, global_dims=DIMS)
        for i, (light, intensity) in enumerate(lights):
            r.add_light(f"l{i}", DirLight.create(light, intensity))
        if clipped:
            r.set_clip_plane(ClipPlane.create(*CLIP))
        camera = Camera.look_at(np.asarray(cam), np.zeros(3),
                                fov_degrees=35.0)
        for step in range(3):
            if step == 1:
                r.set_clip_plane(ClipPlane.create(*CLIP))
            if step == 2:
                r.set_window_center(CENTER)
            img = r.render(camera, *SIZE)
            lv = gather(r.light_volume)
            if rank == 0:
                out[f"{name}_img{step}"] = img.numpy()
                out[f"{name}_lv{step}"] = lv
            else:
                assert img is None
        held = [t.numel() for t in (r.volume, r.light_volume,
                                    r._held.data)]
        held += [b.numel() for b in r.buffers()]
        largest = max(largest, *held)
    try:
        Renderer(slab[:, :, 1:].clone(), tf_table=table, device="cpu",
                 mesh=mesh, global_dims=DIMS)
        refused = 0
    except ValueError:
        refused = 1
    flags = torch.tensor([largest, refused], dtype=torch.int64)
    every = [torch.empty_like(flags) for _ in range(world)]
    dist.all_gather(every, flags)
    if rank == 0:
        every = torch.stack(every).numpy()
        out["largest"] = every[:, 0]
        out["refused"] = every[:, 1]
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
