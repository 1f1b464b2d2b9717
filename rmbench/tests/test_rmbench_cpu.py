"""Each cell's mix driven for a few iterations at a tiny size on the CPU,
through the port's plain paths, and held against the reference (which
agrees there to the bit); the result line's keys."""

import json

import pytest
import _tiny

from rmbench import harness
from rmbench import run as rmrun

FRAMES = ["ct256_bone.orbit", "luna16_chest.clip_drag", "ct256_bone.fly",
          "ct256_bone.window_drag"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", FRAMES)
def test_frames_cell_agrees_with_reference(name):
    r = _tiny.run(_tiny.cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["numbers"]["frame_rel_l2"] <= 1e-6
    assert r["numbers"]["frame_trimmed_err"] <= 1e-6
    e2e = {m["name"] for m in _tiny.cell(name).end_to_end}
    assert set(r["metrics"]) == e2e and "setup_s" in e2e and len(e2e) == 3
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_fit_cell_agrees_with_reference():
    r = _tiny.run(_tiny.cell("ct256_bone.fit"))
    assert r["correct"], r["checks"]
    assert r["numbers"]["loss_gap"] <= 1e-5
    assert r["numbers"]["grad_gap"] <= 1e-5
    assert set(r["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("name", FRAMES + ["ct256_bone.fit"])
def test_traced_run_and_result_line(name):
    r = _tiny.run(_tiny.cell(name, trace_iters=4), traced=True)
    line, notes = rmrun.finish(r)
    assert KEYS <= set(line) <= KEYS | {"breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert notes[-1].startswith("check ")
    per_layer = {m["name"] for m in _tiny.cell(name).per_layer}
    assert set(line["metrics"]) <= per_layer
    assert any(k.startswith("host_ms") for k in line["metrics"])
    json.dumps(line)


def test_controls_fail_the_limits():
    """The lower-precision controls fail each cell's limits at a size a
    test holds (the card's readings are in the limits files)."""
    for name in FRAMES:
        c = _tiny.cell(name, dims=[48, 40, 32] if "luna" in name else
                       [48, 48, 48], width=160, height=96, steps=48)
        r = _tiny.run(c, control=True)
        assert r["correct"], r["checks"]
        assert any(r["numbers"]["control." + k] > v["limit"]
                   for k, v in r["checks"].items()), (name, r["numbers"])
    r = _tiny.run(_tiny.cell("ct256_bone.fit"), control=True)
    assert r["numbers"]["control.change_gap"] > \
        r["checks"]["change_gap"]["limit"]


# mixes that exist only as data: each drives another of the viewer's
# setters through the one generator, and the reference follows it (a
# light that moves alone is changed incrementally by the renderer, which
# the reference does not follow yet; with the window dragged too, every
# frame rebuilds the illumination at the light's new direction)
NEW_MIXES = {
    "light_and_window_drag": {
        "camera": {"path": "orbit", "deg_per_iteration": 0.5},
        "light": {"axis": [0, 0, 1], "every": 1, "step": 1.0,
                  "min_offset": -20.0, "max_offset": 20.0},
        "window": {"every": 1, "step": 0.002, "min_offset": -0.05,
                   "max_offset": 0.05}},
    "width_drag": {"camera": {"path": "fixed"},
                   "window_width": {"every": 1, "step": 0.004,
                                    "min_offset": -0.1, "max_offset": 0.1}},
    "static_unjittered": {"camera": {"path": "fixed"},
                          "renderer": {"jitter": False}},
}


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_a_mix_made_of_data_alone_runs_against_the_reference(mix):
    base = _tiny.cell("ct256_bone.orbit")
    trf = dict(loop="frames", warmup_iterations=[-1], trace_iterations=4,
               samples=3, **NEW_MIXES[mix])
    c = harness.Cell(_tiny.bench(), "ct256_bone.orbit", base.config, trf)
    r = _tiny.run(c)
    assert r["correct"] and r["attempted"] >= 2, r["checks"]
    assert r["numbers"]["frame_rel_l2"] <= 1e-6


def test_a_stated_precision_the_renderer_does_not_hold_is_refused():
    c = _tiny.cell("ct256_bone.orbit")
    cfg = dict(c.config, precision=dict(c.config["precision"],
                                        volume="float16"))
    with pytest.raises(ValueError, match="states volume"):
        _tiny.run(harness.Cell(_tiny.bench(), c.name, cfg, c.traffic))
