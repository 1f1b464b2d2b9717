"""Checkpoint-restart recovery of the port's `fit` (the JAX package's
`tests/test_recovery.py`, on the port and without JAX).

A worker process (`tests/_torch_recovery_worker.py`) is killed mid-fit
(``os._exit(17)`` right after step 3's checkpoint, as a crash); a second
one resumes from the newest checkpoint. Concatenated, their losses must
equal an uninterrupted run's bit for bit (the CPU is deterministic): the
parameters and the optimizer state round-trip exactly."""

import os
import subprocess
import sys

import numpy as np
import torch

from tbraymarcherplugin_tpu_torch.models.pipeline import RenderParams
from tbraymarcherplugin_tpu_torch.utils import checkpoint as CK

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_recovery_worker.py")
WORKER_TIMEOUT_S = 240


def _run(env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, WORKER], env=env,
                          timeout=WORKER_TIMEOUT_S, capture_output=True,
                          text=True)


def _losses(path):
    steps, vals = [], []
    with open(path) as f:
        for line in f:
            if line.strip() == "KILLED":
                continue
            s, v = line.split()
            steps.append(int(s))
            vals.append(v)  # compared as strings: the same bits print alike
    return steps, vals


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out_a, out_b, out_c = (str(tmp_path / f"{x}.txt") for x in "abc")

    # A: crashes (exit 17) right after step 3's checkpoint
    r = _run({"RECOVERY_CKPT": ckpt, "RECOVERY_OUT": out_a,
              "RECOVERY_KILL_AFTER": "3"})
    assert r.returncode == 17, r.stderr[-2000:]
    steps_a, loss_a = _losses(out_a)
    assert steps_a == [0, 1, 2, 3]
    assert CK.CheckpointManager(ckpt).all_steps() == [1, 2, 3]  # keeps 3

    # B: resumes from the newest checkpoint and finishes
    r = _run({"RECOVERY_CKPT": ckpt, "RECOVERY_OUT": out_b,
              "RECOVERY_RESUME": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    steps_b, loss_b = _losses(out_b)
    assert steps_b == [4, 5, 6]

    # C: an uninterrupted run (fresh checkpoint directory)
    r = _run({"RECOVERY_CKPT": str(tmp_path / "ckpt_c"),
              "RECOVERY_OUT": out_c})
    assert r.returncode == 0, r.stderr[-2000:]
    steps_c, loss_c = _losses(out_c)
    assert steps_c == list(range(7))
    assert loss_a + loss_b == loss_c  # bit-identical continuation


def test_save_restore_round_trips_trees(tmp_path):
    params = RenderParams(torch.rand(3, 4, 5), torch.rand(256, 4),
                          torch.tensor(0.5), torch.tensor(0.8),
                          torch.tensor([1.0, 0.25]))
    opt = torch.optim.Adam([params.tf_table.requires_grad_()], lr=1e-2)
    params.tf_table.grad = torch.ones_like(params.tf_table)
    opt.step()
    tree = {"params": params, "opt": opt.state_dict(),
            "misc": [np.arange(3, dtype=np.int32), (1, "a", None)]}
    path = str(tmp_path / "x" / "tree")
    CK.save_pytree(path, tree, {"note": "hi"})
    with np.load(path + ".npz") as z:
        assert "metadata_json" in z.files and "leaf_0" in z.files
    got, meta = CK.restore_pytree(path, None)
    assert meta == {"note": "hi"}
    for f in ("volume", "tf_table", "window_center", "window_width",
              "light_intensities"):
        a, b = getattr(got["params"], f), getattr(params, f)
        assert a.device.type == "cpu" and torch.equal(a, b.detach())
    st = got["opt"]["state"][0]
    want = opt.state_dict()["state"][0]
    for k in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(st[k], want[k]), k
    assert got["opt"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert got["misc"][1] == (1, "a", None)
    np.testing.assert_array_equal(got["misc"][0].numpy(), np.arange(3))

    mgr = CK.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    (tree3, meta3) = mgr.restore({"x": torch.zeros(2)})
    assert meta3["step"] == 3 and torch.equal(tree3["x"], torch.full((2,), 3.))
    (tree2, _) = mgr.restore(None, step=2)
    assert float(tree2["x"][0]) == 2.0
