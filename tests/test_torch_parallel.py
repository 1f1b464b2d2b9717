"""The port's `parallel/` (torch.distributed, gloo on the CPU) against the
JAX package's.

A module-scoped fixture writes the scenes' arrays (the JAX package's
generators, tests/test_sharding.py's scenes) and runs
`_torch_parallel_worker.py` once at each world size, 1, 2, 4 and 8
processes of one thread each, all at once. The results are held here:

- against the JAX sharded functions on the virtual 8-device mesh where
  tests/test_sharding.py runs them in the fast tier, at that test's limits
  (rtol 1e-5, atol 1e-6): the ray-tile render (world 8, the 13x7 padding,
  the rays 4 x slab 2 mesh) and the shear-warp render;
- where the JAX test is slow, against the single-device JAX function that
  test holds the sharded one to, at its limits: the slab march and the
  ring (rtol 1e-4, atol 1e-5), the slab-local illumination with one
  and two lights (rtol 1e-5, atol 1e-6);
- against the port itself: the differentiable shear-warp at world 2
  against the single-device fused path (the JAX diff test's limits, rtol
  5e-3, atol 1e-5 of the largest value; that path is held to JAX by
  tests/test_torch_grad_*.py), the overlapped all-reduce against the bulk
  one at world 8 (tests/test_sharding.py's limits) and a world-2 train
  step against world 1 (tests/test_multiprocess.py's limits);
- at world 1, each sharded function against its single-device counterpart
  in the port, bit for bit.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from tbraymarcherplugin_tpu.models import pipeline as JP
from tbraymarcherplugin_tpu.ops import compositing as JC
from tbraymarcherplugin_tpu.ops import march as JM
from tbraymarcherplugin_tpu.ops import rays as JR
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops import synthetic as JSyn
from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.parallel import make_mesh as j_make_mesh
from tbraymarcherplugin_tpu.parallel import ray_sharding as JRS
from tbraymarcherplugin_tpu.parallel import shearwarp_sharding as JSS
from tbraymarcherplugin_tpu.scene import Camera, VolumeTransform
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import compositing as PC
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.parallel import distributed as PD
from tbraymarcherplugin_tpu_torch.parallel import mesh as PMesh
from tbraymarcherplugin_tpu_torch.parallel import overlap as PO
from tbraymarcherplugin_tpu_torch.parallel import ray_sharding as PRS
from tbraymarcherplugin_tpu_torch.parallel import shearwarp_sharding as PSS

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = (1, 2, 4, 8)
SPAWN_TIMEOUT = 400
NO_CLIP = tuple(jnp.asarray(x, jnp.float32) for x in W.NO_CLIP)


def _ramp():
    return np.asarray(JT.tf_from_keypoints([0, 1], [[0, 0, 0, 0],
                                                    [1, 1, 1, 1]]))


def _jrays(cam, w, h):
    camera = Camera.look_at(cam, [0.0, 0.0, 0.0], fov_degrees=30.0)
    return JR.setup_rays(camera, VolumeTransform.create(), w, h)


def _inputs():
    """The scenes' arrays, from the JAX package's generators."""
    out = dict(
        a_vol=JSyn.sphere_volume(W.DIMS, radius=0.35),
        ring_vol=JSyn.sphere_volume(W.DIMS, radius=0.45),
        t_vol=JSyn.sphere_volume((8, 8, 8), radius=0.4),
        sw_vol=JSyn.ct_like_phantom(W.DIMS, seed=1),
        d_vol=JSyn.ct_like_phantom(W.DIMS, seed=0),
        d_target=np.random.default_rng(0).random(
            (W.D_SIZE[1], W.D_SIZE[0], 4), dtype=np.float32),
        ramp_tf=_ramp(), bone_tf=JT.tf_ct_bone(),
        ring_tf=JT.tf_from_keypoints([0, 1], [[0, 0, 0, 0.2], [1, 1, 1, 1]]),
        v2_tf=JT.tf_from_keypoints([0, 1], [[0.2, 0.2, 0.2, 0.1],
                                            [1, 1, 1, 0.9]]),
    )
    for i, (vdims, _) in enumerate(W.V2_CASES):
        out[f"v2_vol{i}"] = JSyn.ct_like_phantom(vdims, seed=2)
    for name, cam, size in (("a", W.CAM_A, (12, 12)),
                            ("pad", W.CAM_PAD, (13, 7)),
                            ("ring_p", W.CAM_A, (12, 12)),
                            ("ring_n", W.CAM_DOWN, (10, 10)),
                            ("t", W.CAM_A, (8, 8))):
        rays = _jrays(cam, *size)
        for k, x in zip(("entry", "dir", "thick"), rays):
            out[f"{name}_{k}"] = x
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """{world: the worker's results}: every world size spawned once, all at
    the same time."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = str(tmp / "inputs.npz")
    np.savez(inp, **inputs)
    procs = {}
    for world in WORLDS:
        # a file store per world: no port to race other processes for
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       COORD=f"file://{tmp / f'store{world}'}",
                       OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(HERE))
            procs[world, rank] = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
                 inp, str(tmp / f"out{world}.npz")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {k: p.communicate(timeout=SPAWN_TIMEOUT)[0].decode(errors="replace")
            for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"world {k[0]} rank {k[1]}:\n{logs[k][-3000:]}"
    return {w: dict(np.load(tmp / f"out{w}.npz")) for w in WORLDS}


def _params_j(inp, vol="a_vol", tf="ramp_tf", intensities=(1.0,)):
    return JP.RenderParams(
        volume=jnp.asarray(inp[vol]), tf_table=jnp.asarray(inp[tf]),
        window_center=jnp.asarray(0.5), window_width=jnp.asarray(1.0),
        light_intensities=jnp.asarray(intensities, jnp.float32))


def _jrays_of(inp, name):
    return JR.RayBatch(*(jnp.asarray(inp[f"{name}_{k}"])
                         for k in ("entry", "dir", "thick")))


def _plans_j(dirs, dims=W.DIMS):
    return tuple(JP.LightPlan.create(d, dims) for d in dirs)


# --- ops/compositing.py --------------------------------------------------


def test_compose_segments_and_accumulate_masked_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.random((5, 7, 4), dtype=np.float32) for _ in range(2))
    mask = rng.random((5, 7)) > 0.5
    np.testing.assert_allclose(
        PC.compose_segments(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JC.compose_segments(a, b)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        PC.accumulate_masked(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(mask)).numpy(),
        np.asarray(JC.accumulate_masked(a, b, mask)), rtol=1e-6, atol=1e-7)


# --- host helpers ----------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_local_plan_matches_jax_field_by_field(rank):
    """The port's slab plan is a column window of the full plan (j0); its
    re-based coefficients, which K1's and K5's in-cube test reads, are the
    JAX package's re-based fields bit for bit."""
    cam = Camera.look_at(W.D_CAM, [0.0, 0.0, 0.0], fov_degrees=W.D_FOV)
    jplan = JSW.plan_shearwarp(cam, VolumeTransform.create(), W.DIMS, W.DIMS,
                               *W.D_SIZE, max_n=256, align=256)
    pplan = W._sw_plan(W.D_CAM, W.D_FOV, W.D_SIZE, max_n=256, align=256)
    n2_local = pplan.n2 // 4
    got = PSS._local_plan(pplan, rank, n2_local)
    want = JSS._local_plan(jplan, jnp.int32(rank), n2_local)
    assert got.n2 == want.n2 == n2_local and got.j0 == rank * n2_local
    for f, x in zip(("a2", "la2", "o2"), PSW.rebased_columns(got)):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(getattr(want, f), np.float32),
                                      err_msg=f)
    assert isinstance(PSW.rebased_columns(got)[2], np.float32)
    assert PSW.columns(got).tolist() == list(range(rank * n2_local,
                                                   (rank + 1) * n2_local))


def test_pad_rays_for_mesh_matches_jax(inputs):
    jflat, jn = JRS.pad_rays_for_mesh(_jrays_of(inputs, "pad"), 8)
    rays = PR.RayBatch(*(torch.tensor(inputs[f"pad_{k}"])
                         for k in ("entry", "dir", "thick")))
    pflat, pn = PRS.pad_rays_for_mesh(rays, 8)
    assert pn == jn == 91 and pflat.thickness.shape == (96,)
    for got, want in zip(pflat, jflat):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- against the JAX sharded functions (fast tier of test_sharding.py) ------


def test_render_lit_sharded_matches_jax_sharded(inputs, runs):
    want = JRS.render_lit_sharded(
        j_make_mesh({"rays": 8}), _params_j(inputs), _jrays_of(inputs, "a"),
        *NO_CLIP, _plans_j([W.LIGHT_A]), W.DIMS, step_count=24)
    assert runs[8]["ray"].shape == (12, 12, 4)
    np.testing.assert_allclose(runs[8]["ray"], np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_render_lit_sharded_padding_odd_count(inputs, runs):
    want = JRS.render_lit_sharded(
        j_make_mesh({"rays": 8}), _params_j(inputs), _jrays_of(inputs, "pad"),
        *NO_CLIP, _plans_j([W.LIGHT_A]), W.DIMS, step_count=16)
    assert runs[8]["pad"].shape == (7, 13, 4)
    np.testing.assert_allclose(runs[8]["pad"], np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_2d_mesh_rays_and_slab(inputs, runs):
    want = JRS.render_lit_sharded(
        j_make_mesh({"rays": 4, "slab": 2}), _params_j(inputs),
        _jrays_of(inputs, "a"), *NO_CLIP, _plans_j([W.LIGHT_A]), W.DIMS,
        step_count=16)
    np.testing.assert_allclose(runs[8]["mesh2d"], np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_shearwarp_lit_sharded_matches_jax_sharded(inputs, runs):
    cam = Camera.look_at(W.SW_CAM, [0, 0, 0], fov_degrees=W.SW_FOV)
    plan = JSW.plan_shearwarp(cam, VolumeTransform.create(), W.DIMS, W.DIMS,
                              *W.SW_SIZE, max_n=128, align=8)
    want = np.asarray(JSS.shearwarp_lit_sharded(
        j_make_mesh({"rays": 8}), jnp.asarray(inputs["sw_vol"]),
        jnp.asarray(inputs["bone_tf"]), jnp.ones(W.DIMS, jnp.float32), plan,
        jnp.asarray(W.SW_WIN, jnp.float32), *NO_CLIP, *W.SW_SIZE))
    assert want[..., 3].max() > 0.1
    # The port against JAX at the dense shear-warp's port-vs-JAX limit
    # (tests/test_torch_shearwarp.py): the two single-device frames already
    # differ by 3.3e-6 on this scene, above the JAX test's 1e-6 + 1e-5 |x|
    # on 3 of 12288 values. The split itself is exact: the slabs evaluate
    # their columns at the full grid's indices (`ShearWarpPlan.j0`).
    np.testing.assert_allclose(runs[8]["sw"], want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(runs[8]["sw"], runs[1]["sw_single"])


# --- against the single-device JAX functions (slow tier of test_sharding.py) -


def test_slab_march_matches_jax_march_lit(inputs, runs):
    params = _params_j(inputs)
    lv = JP.compute_illumination(params, _plans_j([W.LIGHT_A]), *NO_CLIP,
                                 W.DIMS)
    want = JM.march_lit(params.volume, params.tf_table, lv,
                        _jrays_of(inputs, "a"),
                        jnp.asarray(W.WIN_A, jnp.float32), *NO_CLIP,
                        step_count=24, early_termination=2.0)
    np.testing.assert_allclose(runs[8]["slab"], np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("key", ["ring_p", "ring_n"])
def test_slab_ring_matches_jax_march_lit(inputs, runs, key):
    want = np.asarray(JM.march_lit(
        jnp.asarray(inputs["ring_vol"]), jnp.asarray(inputs["ring_tf"]),
        jnp.ones(W.DIMS, jnp.float32), _jrays_of(inputs, key),
        jnp.asarray(W.WIN_A, jnp.float32), *NO_CLIP, step_count=24))
    if key == "ring_p":  # the scene hits the alpha snap
        assert (want[..., 3] == 1.0).any()
    else:  # every ray points down Z
        assert (inputs["ring_n_dir"][..., 2] < 0).all()
    np.testing.assert_allclose(runs[8][key], want, rtol=1e-4, atol=1e-5)


def test_illumination_one_light_matches_jax(inputs, runs):
    want = JP.compute_illumination(_params_j(inputs), _plans_j([W.LIGHT_A]),
                                   *NO_CLIP, W.DIMS)
    np.testing.assert_allclose(runs[8]["illum_one"], np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_illumination_v2_matches_jax(inputs, runs):
    want = JP.compute_illumination(
        _params_j(inputs, intensities=(1.0, 0.7)),
        _plans_j([W.LIGHT_A, W.LIGHT_B]), *NO_CLIP, W.DIMS)
    np.testing.assert_allclose(runs[8]["illum_v2"], np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", [0, 1])
def test_illumination_v2_nonuniform_light_dims(inputs, runs, case):
    vdims, ldims = W.V2_CASES[case]
    want = JP.compute_illumination(
        _params_j(inputs, f"v2_vol{case}", "v2_tf", (1.0, 0.6)),
        _plans_j([W.LIGHT_A, W.LIGHT_B], ldims), *NO_CLIP, ldims)
    assert runs[4][f"v2_{case}"].shape == ldims
    np.testing.assert_allclose(runs[4][f"v2_{case}"], np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# --- against the port ------------------------------------------------------


def test_diff_shearwarp_world2_matches_single_device(runs):
    one, two = runs[1], runs[2]
    assert one["diff_single_img"][..., 3].max() > 0.1
    np.testing.assert_allclose(two["diff_img"], one["diff_single_img"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two["diff_loss"], one["diff_single_loss"],
                               rtol=1e-5)
    for name in ("dvol", "dtf", "dwin"):
        want = one["diff_single_" + name]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(
            two["diff_" + name], want, rtol=5e-3,
            atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=name)


def test_overlapped_allreduce_matches_bulk_world8(inputs, runs):
    r = runs[8]
    assert not np.array_equal(r["ovl_bulk_tf_table"], inputs["ramp_tf"])
    np.testing.assert_allclose(r["ovl_overlap_loss"], r["ovl_bulk_loss"],
                               rtol=1e-6)
    for f in PRS.FIELDS:
        np.testing.assert_allclose(r[f"ovl_overlap_{f}"], r[f"ovl_bulk_{f}"],
                                   rtol=1e-5, atol=1e-7, err_msg=f)


def test_train_step_world2_matches_world1(runs):
    one, two = runs[1], runs[2]
    np.testing.assert_allclose(two["train_loss"], one["train_loss"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(two["train_loss2"], one["train_loss2"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(two["train_tf"], one["train_tf"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(two["train_wc"], one["train_wc"], rtol=1e-5,
                               atol=1e-7)
    assert float(two["train_loss2"]) != float(two["train_loss"])


@pytest.mark.parametrize("key", [
    "ray", "pad", "sw", "slab", "ring_p", "ring_n", "diff_img", "diff_loss",
    "diff_dvol", "diff_dtf", "diff_dwin", "illum_one", "illum_v2"])
def test_world1_is_the_single_device_path_bit_for_bit(runs, key):
    one = runs[1]
    single = {"illum_one": "illum_single", "illum_v2": "illum2_single"}.get(
        key, key.replace("diff_", "diff_single_") if key.startswith("diff_")
        else key + "_single")
    np.testing.assert_array_equal(one[key], one[single])


def test_world1_overlap_and_bulk_steps_give_the_same_bits(runs):
    one = runs[1]
    for k in ("loss", "tf", "wc", "loss2", "vol2"):
        np.testing.assert_array_equal(one["train_ov_" + k],
                                      one["train_" + k], err_msg=k)


def test_world8_slabs_are_the_single_device_path(runs):
    """Every rank's share at world 8 adds up to the single-device result:
    the shear-warp columns and the ring bit for bit; the ray tiles (the
    CPU's vector loops round a batch's tail apart), the segment compose
    and the illumination within float32 ulps."""
    one, eight = runs[1], runs[8]
    for key in ("sw", "ring_p", "ring_n"):
        np.testing.assert_array_equal(eight[key], one[key + "_single"],
                                      err_msg=key)
    for key, single in (("ray", "ray_single"), ("pad", "pad_single"),
                        ("slab", "slab_single"), ("illum_one", "illum_single"),
                        ("illum_v2", "illum2_single")):
        np.testing.assert_allclose(eight[key], one[single], rtol=1e-6,
                                   atol=1e-7, err_msg=key)


# --- errors and the process group ------------------------------------------


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_grad_allreduce_axis_rejects_march_impl(impl):
    params = PP.RenderParams(torch.zeros(4, 4, 4), torch.zeros(256, 4),
                             torch.tensor(0.5), torch.tensor(1.0),
                             torch.ones(1))
    rays = PR.RayBatch(torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="grad_allreduce_axis unsupported"):
        PP.render_lit_scene(params, rays, *W.NO_CLIP, (), (4, 4, 4),
                            march_impl=impl, grad_allreduce_axis=PO.LOCAL)


def test_make_mesh_size_error():
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        PMesh.make_mesh({"rays": 2})


def test_initialize_multihost_idempotent_and_is_primary(tmp_path,
                                                        monkeypatch):
    import torch.distributed as dist

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized() and PD.is_primary()
    PD.initialize_multihost(device="cpu")  # a single process: no group
    assert not dist.is_initialized()
    store = f"file://{tmp_path / 'store'}"
    try:
        PD.initialize_multihost(store, 1, 0, device="cpu")
        group = dist.group.WORLD
        PD.initialize_multihost(store, 1, 0, device="cpu")  # a no-op
        assert dist.group.WORLD is group and dist.get_backend() == "gloo"
        assert PD.is_primary()
        mesh = PMesh.make_mesh({"rays": 1, "slab": 1})
        assert mesh.mesh_dim_names == ("rays", "slab")
        assert PMesh.replicated(mesh) == (PMesh.Replicate(), PMesh.Replicate())
        assert PMesh.sharded_along(mesh, "slab", 2) == (PMesh.Replicate(),
                                                        PMesh.Shard(2))
        with pytest.raises(ValueError, match="no axis"):
            PMesh.sharded_along(mesh, "rows")
    finally:
        dist.destroy_process_group()
    assert PD.backend_for("cpu") == "gloo" and PD.backend_for() == "nccl"
    assert PD.backend_for("cuda:0") == "nccl"


def test_parallel_check_tool_on_cpu(capfd):
    """`tools/parallel_check.py`, the cross-GPU check, as a rehearsal: two
    gloo processes at the small scene, every path within its limits."""
    from tbraymarcherplugin_tpu_torch.tools import parallel_check

    assert parallel_check.main(["--nproc", "2", "--device", "cpu",
                                "--scene", "small"]) == 0
    out = capfd.readouterr().out  # the ranks print from their processes
    assert out.count("| ok |") == 8 and "FAILED" not in out
