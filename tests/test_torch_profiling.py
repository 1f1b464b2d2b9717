"""The port's profiling helpers (`utils/profiling.py`): the spans (nothing
built while no profiler records; where a frame, a rebuild and a fit step
open them), the upload helper `utils.device.to_device`, the phase
tracer's JSON (the JAX package's format) and the device trace on
`torch.profiler` (CPU activity here; CUDA too on the card)."""

import json
import os

import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch import convert
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.models import pipeline as PP
from tbraymarcherplugin_tpu_torch.ops import rays as PR
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.ops import transfer as PT
from tbraymarcherplugin_tpu_torch.renderer import Renderer, RendererConfig
from tbraymarcherplugin_tpu_torch.utils import profiling as P
from tbraymarcherplugin_tpu_torch.utils.device import to_device

DIMS = (16, 16, 16)
W, H = 40, 30
CAM = ((0.1, -2.3, 0.4), (0.0, 0.0, 0.0))
LIGHT = (0.3, 0.1, -0.95)


class _Counted:
    """An ``args`` value that counts its formatting."""

    def __init__(self):
        self.formatted = 0

    def __str__(self):
        self.formatted += 1
        return "counted"


def _tbr_events(prof):
    """[(name, [ancestor names, innermost first])] of the ``tbr.`` ranges
    of a finished profile, in start order."""
    out = []
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    for e in events:
        if not e.name.startswith("tbr."):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("tbr."):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e.name, chain))
    return out


def _renderer():
    vol = synthetic.ct_like_phantom(DIMS, seed=0)
    r = Renderer(vol, tf_table=PT.tf_ct_bone(device="cpu"),
                 config=RendererConfig(step_count=12), device="cpu")
    r.add_light("sun", PS.DirLight.create(LIGHT, 1.0))
    return r


def test_span_off_builds_nothing(monkeypatch):
    built = []
    monkeypatch.setattr(P, "record_function",
                        lambda *a: built.append(a) or P._OFF)
    args = _Counted()
    assert not torch.autograd._profiler_enabled()
    first = P.span(P.RENDER, args)
    assert first is P._OFF and P.span(P.LIGHT_SCAN, args) is first
    with P.span(P.PLAN):
        pass
    assert built == [] and args.formatted == 0


def test_span_on_records_a_range_with_its_args(monkeypatch):
    args = _Counted()
    with torch.profiler.profile() as prof:
        with P.span(P.LIGHT_SCAN, args):
            torch.ones(4) + 1
    assert args.formatted == 1
    assert [name for name, _ in _tbr_events(prof)] == [P.LIGHT_SCAN]


def test_renderer_frame_spans_nest():
    r = _renderer()
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    with torch.profiler.profile() as prof:
        r.render(cam, W, H)
    spans = _tbr_events(prof)
    names = [n for n, _ in spans]
    parents = dict(spans)
    assert names[0] == P.RENDER and parents[P.RENDER] == []
    assert parents[P.LIGHTING] == [P.RENDER]
    assert parents[P.OCCLUDER] == [P.LIGHTING, P.RENDER]
    assert parents[P.LIGHT_SCAN] == [P.LIGHTING, P.RENDER]
    for name in (P.PLAN, P.PRESHEAR, P.COMPOSITE, P.WARP):
        assert parents[name] == [P.RENDER], name
    # the rebuild, then the plan, the pre-shear, K1 and the warp
    order = [names.index(n) for n in (P.LIGHTING, P.PLAN, P.PRESHEAR,
                                      P.COMPOSITE, P.WARP)]
    assert order == sorted(order)
    assert names.count(P.OCCLUDER) == names.count(P.LIGHT_SCAN) >= 1
    assert P.RAYS not in names and P.MARCH not in names


def test_second_frame_of_a_camera_plans_and_lights_nothing():
    r = _renderer()
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    r.render(cam, W, H)
    with torch.profiler.profile() as prof:
        r.render(cam, W, H)
    names = [n for n, _ in _tbr_events(prof)]
    assert P.RENDER in names and P.PRESHEAR in names
    for absent in (P.PLAN, P.LIGHTING, P.OCCLUDER, P.LIGHT_SCAN):
        assert absent not in names, absent
    r.set_window_center(0.45)
    with torch.profiler.profile() as prof:
        r.render(cam, W, H)
    names = [n for n, _ in _tbr_events(prof)]
    assert names.count(P.LIGHTING) == 1 and P.PLAN not in names


def test_march_frame_spans():
    r = _renderer()
    with torch.profiler.profile() as prof:
        inside = PS.Camera.look_at((0.1, -0.3, 0.05), (0.0, 0.0, 0.0),
                                   fov_degrees=60.0)
        r.render(inside, W, H)
    spans = _tbr_events(prof)
    parents = dict(spans)
    assert [n for n, _ in spans][:2] == [P.CAMERA, P.RENDER]
    assert parents[P.CAMERA] == [] and parents[P.RENDER] == []
    assert parents[P.RAYS] == [P.RENDER] and parents[P.MARCH] == [P.RENDER]
    assert P.PRESHEAR not in parents


def test_fit_step_records_the_scene_and_backward_spans():
    vol = synthetic.ct_like_phantom(DIMS, seed=0)
    params, plans = convert.to_port_render_params(
        {"volume": vol, "tf_table": PT.tf_ct_bone().numpy(),
         "window_center": np.float32(0.55), "window_width": np.float32(0.8),
         "light_intensities": np.asarray([0.9], np.float32)},
        (LIGHT,), DIMS, device="cpu", requires_grad=True)
    cam = PS.Camera.look_at(*CAM, fov_degrees=40.0)
    tr = PS.VolumeTransform.create()
    plan = PSW.plan_shearwarp(cam, tr, DIMS, DIMS, W, H, max_n=64)
    rays = PR.setup_rays(cam, tr, W, H)
    clip = PS.ClipPlane.disabled()
    with torch.profiler.profile() as prof:
        img = PP.render_lit_scene(params, rays, clip.center, clip.direction,
                                  plans, DIMS, march_impl="shearwarp",
                                  shearwarp_plan=plan,
                                  shearwarp_tf_unit="fused")
        img.sum().backward()
    parents = dict(_tbr_events(prof))
    assert parents[P.SCENE] == []
    for name in (P.OCCLUDER, P.LIGHT_SCAN, P.PRESHEAR, P.COMPOSITE, P.WARP):
        assert P.SCENE in parents[name], name
    for name in (P.COMPOSITE_BWD, P.WARP_BWD, P.LIGHT_SCAN_BWD,
                 P.TF_ALPHA_BWD):
        assert name in parents and P.SCENE not in parents[name], name


@pytest.mark.parametrize("x, dtype", [
    (np.arange(6, dtype=np.float32).reshape(2, 3), None),
    (np.arange(4, dtype=np.int64), None),
    (np.asarray([0.1, 0.2], np.float64), torch.float32),
    ([0.5, 0.8, 1.0, 0.0], torch.float32),
    ((16, 8, 4), torch.float32),
    (torch.Size([16, 8, 4]), torch.float32),
    (torch.linspace(0.0, 1.0, 5, dtype=torch.float64), torch.float32),
    (3.25, None),
])
def test_to_device_is_as_tensor(x, dtype):
    got = to_device(x, "cpu", dtype)
    want = torch.as_tensor(x, dtype=dtype, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_to_device_spans_only_copies_to_a_device():
    with torch.profiler.profile() as prof:
        to_device(np.ones(3, np.float32), "cpu")
        to_device(torch.ones(3), "cpu")
        on_meta = to_device(np.ones(3, np.float32), "meta")
        to_device(on_meta, "meta")
        to_device([1.0, 2.0], torch.device("meta"), torch.float32)
    assert on_meta.device.type == "meta"
    assert [n for n, _ in _tbr_events(prof)] == [P.UPLOAD, P.UPLOAD]




def test_phase_tracer_matches_jax_format():
    from tbraymarcherplugin_tpu.utils.profiling import PhaseTracer as JTracer

    reports = []
    for tracer in (P.PhaseTracer(), JTracer()):
        tracer.frame()  # outside a phase: not counted
        with tracer.phase("warm"):
            pass
        with tracer.phase("frames"):
            tracer.frame(3)
        reports.append(json.loads(tracer.report()))
        summary = tracer.summary()
        assert set(summary) == {"warm", "frames"}
        assert summary["frames"] == round(
            reports[-1][1]["ms_per_frame"], 3)
    got, want = reports
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    assert [(p["name"], p["frames"]) for p in got] == [("warm", 0),
                                                       ("frames", 3)]


def test_phase_tracer_records_a_failed_phase():
    tracer = P.PhaseTracer()
    with pytest.raises(RuntimeError):
        with tracer.phase("boom"):
            raise RuntimeError("x")
    assert tracer.phases[0]["name"] == "boom" and tracer._current is None


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with P.device_trace(log_dir=log_dir, name="frame"):
        with P.span("inner"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = os.path.join(log_dir, "frame.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"frame", "inner"} <= names
    assert any("mm" in str(n) for n in names)


def test_device_trace_without_log_dir_only_annotates(tmp_path):
    with torch.profiler.profile() as prof:
        with P.device_trace(name="outer_range"):
            torch.ones(8) + 1
    assert any(e.key == "outer_range" for e in prof.key_averages())
    assert not os.listdir(tmp_path)
