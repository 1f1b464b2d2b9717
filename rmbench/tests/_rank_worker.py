"""A worker of a test run over several ranks (``run.py --worker <dir>
<rank>``) with a plant put in first, named by the first argument:

- ``none``: the worker as it is;
- ``raise``: rank 1 raises in the window's iteration 3;
- ``standin``: the port's `Renderer` replaced by one that prints what it
  is built from (a ``{"standin": ...}`` line on standard error) and then
  renders the whole volume, gathered from the ranks' slabs over the mesh.
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rmbench import run, system  # noqa: E402


def plant_raise(rundir: Path, rank: int) -> None:
    spec = json.loads((rundir / "spec.json").read_text())
    at = len(spec["traffic"]["warmup_iterations"]) + 3
    render, count = system.Viewer.render, [0]

    def wrapped(self, state):
        if rank == 1 and count[0] == at:
            raise RuntimeError("planted fault: rank 1, iteration 3")
        count[0] += 1
        return render(self, state)

    system.Viewer.render = wrapped


def plant_standin() -> None:
    from tbraymarcherplugin_tpu_torch import renderer as R

    class StandIn(R.Renderer):
        def __init__(self, volume, *args, mesh=None, global_dims=None,
                     **kwargs):
            record = json.dumps({"standin": {
                "shape": list(volume.shape),
                "global_dims": list(global_dims),
                "mesh_dims": list(mesh.mesh_dim_names),
                "mesh_size": mesh.size()}})
            os.write(2, (record + "\n").encode())  # one write: whole
            parts = [torch.empty_like(volume) for _ in range(mesh.size())]
            dist.all_gather(parts, volume.contiguous(),
                            group=mesh.get_group("slab"))
            super().__init__(torch.cat(parts, dim=2), *args, **kwargs)

    R.Renderer = StandIn


if __name__ == "__main__":
    plant, argv = sys.argv[1], sys.argv[2:]
    rundir, rank = Path(argv[1]), int(argv[2])
    if plant == "raise":
        plant_raise(rundir, rank)
    elif plant == "standin":
        plant_standin()
    sys.exit(run.main(argv))
