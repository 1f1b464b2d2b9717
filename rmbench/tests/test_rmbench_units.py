"""The yardstick's pieces: the traffic generator, the phantom, the trace
reduction, the bounds and the frame sample."""

import math

import numpy as np
import pytest
import torch
import _tiny

from rmbench import bounds, generator, harness, phantom
from rmbench import trace as tracing
from rmbench.reference import frame as RF
from rmbench.reference import scene as RS


def _gen(cell):
    c = harness.Cell(_tiny.bench(), cell)
    return c.gen, c.config


def test_orbit_is_the_cli_formula_from_the_bench_camera():
    from tbraymarcherplugin_tpu_torch.tools.render_cli import orbit_camera

    gen, _ = _gen("ct256_bone.orbit")
    s0 = gen.state(0)
    assert np.allclose(s0.position, (0.1, -2.3, 0.4), atol=1e-12)
    for i in (1, 90, 719, 720):
        s = gen.state(i)
        cam = orbit_camera(gen.azimuth0 + 0.5 * i, gen.elevation,
                           gen.distance, 40.0)
        assert np.allclose(s.position, cam.position, atol=1e-5)
    assert np.allclose(gen.state(720).position, s0.position, atol=1e-9)
    # nothing but the camera moves: the illumination is never rebuilt
    assert len({(s.window_center, s.window_width, s.clip, s.lights)
                for s in map(gen.state, range(-3, 50))}) == 1


def test_clip_drag_bounces_and_dirties_every_frame():
    gen, cfg = _gen("luna16_chest.clip_drag")
    d = np.asarray([0.3, -0.8, 0.52]) / np.linalg.norm([0.3, -0.8, 0.52])
    width = float(np.sum(np.abs(d) * generator.world_scale(cfg)))
    ts = [float(np.dot(gen.state(i).clip[0], d) / width + 0.5)
          for i in range(0, 401)]
    assert min(ts) == pytest.approx(0.3) and max(ts) == pytest.approx(0.7)
    assert ts[100] == pytest.approx(0.7) and ts[200] == pytest.approx(0.3)
    assert all(gen.state(i).clip != gen.state(i - 1).clip
               for i in range(1, 400))
    scale = generator.world_scale(cfg)
    assert np.allclose(scale, (35.84, 35.84, 30.72))


def _marches(s):
    """The camera of state ``s`` sits inside the volume's dominant slab:
    no shear-warp plan, the frame marches."""
    cam = RS.Camera.look_at(s.position, s.target, fov_degrees=s.fov_deg)
    scene = RF.Scene(torch.zeros((16, 16, 16)), None, (0.5, 0.8, 1, 1),
                     RS.VolumeTransform.create(), (), RS.ClipPlane
                     .disabled(), 64, 36)
    return all(abs(x) < 0.5 for x in s.position) and RF.plan(scene, cam) \
        is None


def test_fly_marches_every_frame_and_moves_nothing_else():
    gen, _ = _gen("ct256_bone.fly")
    states = [gen.state(i) for i in range(-4, 120)]
    assert all(_marches(s) for s in states[::7])
    assert len({(s.window_center, s.clip, s.lights) for s in states}) == 1
    d = [np.linalg.norm(np.subtract(states[k + 1].position,
                                    states[k].position))
         for k in range(4, 100)]
    assert np.allclose(d, 0.002)


def test_window_drag_steps_the_window_every_frame():
    gen, _ = _gen("ct256_bone.window_drag")
    centers = [gen.state(i).window_center for i in range(0, 400)]
    assert min(centers) == pytest.approx(0.45)
    assert max(centers) == pytest.approx(0.55)
    assert all(a != b for a, b in zip(centers, centers[1:]))
    assert all(abs(a - b) == pytest.approx(0.002)
               for a, b in zip(centers, centers[1:]))
    assert len({gen.state(i).position for i in range(0, 400)}) == 1
    assert _marches(gen.state(0))
    # the warm-up's windows lie on the path and move too
    warm = [gen.state(i).window_center for i in (1, 2, 3)]
    assert len(set(warm + [centers[0]])) == 4


def test_light_track_turns_the_light_about_its_axis():
    cfg = harness.load_config("ct256_bone")
    gen = generator.Generator(cfg, {
        "loop": "frames", "light": {"axis": [0, 0, 1], "every": 2,
                                    "step": 1.0, "min_offset": -3.0,
                                    "max_offset": 3.0}})
    d0 = np.asarray(cfg["lights"][0]["direction"])
    assert gen.state(-1).lights[0][0] == tuple(float(x) for x in d0)
    for i, deg in ((0, 0.0), (2, 1.0), (5, 2.0), (6, 3.0), (8, 2.0)):
        d, inten = gen.state(i).lights[0]
        a = math.radians(deg)
        rot = np.array([[math.cos(a), -math.sin(a), 0],
                        [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        assert np.allclose(d, rot @ d0, atol=1e-12) and inten == 1.0


def test_a_mix_may_set_only_what_the_reference_follows():
    cfg = harness.load_config("ct256_bone")
    opts = generator.renderer_options(cfg, {"renderer": {"jitter": False}})
    assert opts["jitter"] is False
    assert opts["early_termination"] == cfg["renderer"]["early_termination"]
    with pytest.raises(ValueError, match="reference follows"):
        generator.renderer_options(
            cfg, {"renderer": {"light_volume_half_resolution": True}})


def test_phantom_is_seeded_and_in_range():
    a = phantom.ct_phantom((40, 33, 20), 2**31 + 3, "cpu")
    b = phantom.ct_phantom((40, 33, 20), 2**31 + 3, "cpu")
    c = phantom.ct_phantom((40, 33, 20), 7, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert a.dtype == torch.float32 and a.shape == (40, 33, 20)


def test_phantom_follows_the_numpy_original():
    from tbraymarcherplugin_tpu_torch.ops.synthetic import ct_like_phantom

    dims = (36, 28, 20)
    ref = torch.from_numpy(ct_like_phantom(dims, seed=0))
    ours = phantom.ct_phantom(dims, 0, "cpu")
    # the same shapes; the speckle (sigma 0.015) comes from another source
    assert float((ours - ref).abs().mean()) < 0.02
    assert float((ours - ref).abs().max()) < 0.15


def _ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_trace_reduction():
    events = [
        _ev("user_annotation", "rmbench.iter.0", 0, 100),
        _ev("user_annotation", "rmbench.iter.1", 100, 100),
        _ev("user_annotation", "rmbench.render", 0, 90),
        _ev("cpu_op", "aten::bmm", 12, 5, **{"External id": 7}),
        _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=2),
        _ev("kernel", "void gemm<float, 4>(float*)", 20, 30,
            correlation=1, **{"External id": 7}),
        _ev("cpu_op", "_FusedCompositeBackward", 118, 5,
            **{"External id": 9}),
        _ev("kernel", "void composite_kernel<float, 0>(float const*)", 40,
            20, correlation=2, **{"External id": 9}),
        _ev("gpu_memcpy", "Memcpy HtoD", 150, 10),
    ]
    tr = tracing.reduce_events(events, 200e-6)
    assert tr.busy_s == pytest.approx(50e-6)  # [20, 60] and [150, 160]
    assert tr.aten_s() == pytest.approx(30e-6)
    assert tr.kernel_s(("composite_kernel",)) == pytest.approx(20e-6)
    assert tr.kernel_s(("composite_kernel",), {0}) == 0.0
    assert tr.kernel_s(("composite_kernel",), {1}) == pytest.approx(20e-6)
    assert [op.name for op in tr.ops] == ["aten::bmm", "composite_kernel",
                                          "Memcpy HtoD"]
    gaps = dict(tr.top_gaps())
    assert gaps["rmbench.render"] == pytest.approx(20e-6)  # [0, 20]
    assert gaps["host outside any operator"] == pytest.approx(130e-6)
    assert sum(gaps.values()) == pytest.approx(150e-6)  # 200 - busy


def test_the_harness_collective_is_not_the_programs_work():
    """Device operations launched in the harness's ``rmbench.collective``
    range (the stop flag over several cards) count neither as operations
    nor as busy time; the host's time in it still names idle gaps."""
    events = [
        _ev("user_annotation", "rmbench.iter.0", 0, 100),
        _ev("user_annotation", "rmbench.render", 0, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        _ev("kernel", "void composite_kernel<float, 0>(float const*)", 15,
            20, correlation=1),
        _ev("user_annotation", tracing.HARNESS_RANGE, 50, 50),
        _ev("cpu_op", "aten::fill_", 51, 2, **{"External id": 3}),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=2),
        _ev("kernel", "void fill_kernel(float*)", 55, 1, correlation=2,
            **{"External id": 3}),
        _ev("cuda_driver", "cuLaunchKernelEx", 56, 1, correlation=3),
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 57, 40,
            correlation=3),
    ]
    tr = tracing.reduce_events(events, 100e-6)
    assert [op.name for op in tr.ops] == ["composite_kernel"]
    assert tr.busy_s == pytest.approx(20e-6)
    gaps = dict(tr.top_gaps())
    # [35, 100]: its midpoint lies in the collective
    assert gaps[tracing.HARNESS_RANGE] == pytest.approx(65e-6)
    assert gaps["rmbench.render"] == pytest.approx(15e-6)  # [0, 15]


def test_bounds():
    # bytes-bound and operations-bound arms
    assert bounds.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(0, 67e12) == pytest.approx(1.0)
    counts = {"samples": 1000, "shaded": 400, "steps": 5000}
    t = bounds.composite(counts, 128, 128, 2)
    nbytes = 1400 * 2 + 7 * 128 * 128 * 4 + 4096
    assert t == pytest.approx(max(nbytes / 3.35e12,
                                  (1000 * 32 + 400 * 46) / 67e12))
    assert bounds.light_scan(1000, 2) == pytest.approx(
        max(2 * (16000 + 4096) / 3.35e12, 2 * 1000 * 46 / 67e12))
    assert bounds.march(counts, 10, 10, 4) > 0.0


def test_samples_keep_a_seeded_reservoir_and_the_newest_rebuild():
    s = harness.Samples(3, np.random.default_rng(5))
    for i in range(50):
        s.offer(i, i + 10, torch.full((2,), float(i)), i % 10 == 0)
    items = s.items()
    assert [i for i, _, _ in items] == sorted(i for i, _, _ in items)
    assert 40 in [i for i, _, _ in items]
    for i, r, img in items:
        assert r == i + 10 and float(img[0]) == i
    t = harness.Samples(3, np.random.default_rng(5))
    for i in range(50):
        t.offer(i, i + 10, torch.full((2,), float(i)), i % 10 == 0)
    assert [i for i, _, _ in t.items()] == [i for i, _, _ in items]
    assert math.isfinite(harness._quantile([1.0, 2.0, 3.0], 0.95))
