"""The program's spans in a trace (`spans.py`), the trace reduction's
attribution of device time under them (`trace.py`) and the spans it keeps
for readers (``Trace.spans``), on hand-made Chrome trace events."""

import pytest

from rmbench import spans as S
from rmbench import trace as tracing


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid,
               correlation=corr)


def _events():
    return [
        _ev("user_annotation", "rmbench.iter.0", 0, 1000),
        _ev("user_annotation", "rmbench.iter.1", 1000, 1000),
        _ev("user_annotation", "rmbench.render", 5, 990),
        _ev("user_annotation", "tbr.render", 10, 980),
        _ev("user_annotation", "tbr.lighting", 20, 400),
        _ev("user_annotation", "tbr.occluder", 100, 200,
            **{"External id": 3}),
        # an aten operator inside the occluder: its kernel counts
        _ev("cpu_op", "aten::mul", 120, 30, **{"External id": 4}),
        _launch(130, 11),
        _ev("kernel", "void elementwise_kernel<128, 4>(int)", 500, 50,
            correlation=11, **{"External id": 4}),
        # the same, launched on another thread in the occluder's time
        _ev("cpu_op", "aten::add", 140, 20, tid=2, **{"External id": 5}),
        _launch(150, 12, tid=2),
        _ev("kernel", "void elementwise_kernel<128, 2>(int)", 560, 7,
            correlation=12, **{"External id": 5}),
        # after the occluder, still in the rebuild
        _ev("cpu_op", "aten::cat", 320, 30, **{"External id": 6}),
        _launch(330, 13),
        _ev("kernel", "void cat_kernel(int)", 600, 11, correlation=13,
            **{"External id": 6}),
        # the port's kernel launched through ctypes under a span
        _ev("user_annotation", "tbr.composite", 700, 40,
            **{"External id": 7}),
        _launch(710, 14),
        _ev("kernel", "void composite_kernel<float, 0>(float const*)", 720,
            90, correlation=14, **{"External id": 7}),
        # two plans, one nested in a span of the same name
        _ev("user_annotation", "tbr.plan", 430, 60),
        _ev("user_annotation", "tbr.plan", 440, 20),
        _ev("user_annotation", "tbr.tile_bounds", 1100, 30),
        _ev("user_annotation", "tbr.upload", 1110, 10),
    ]


def test_device_time_counts_only_launches_inside_the_span_on_its_thread():
    sp = S.collect(_events())
    assert sp.launched_device_s({"tbr.occluder"}) == pytest.approx(50e-6)
    # the rebuild holds the occluder's launch and the cat's
    assert sp.launched_device_s({"tbr.lighting"}) == pytest.approx(61e-6)
    # the port's kernel is linked to no aten operator
    assert sp.launched_device_s({"tbr.composite"}) == 0.0
    assert sp.launched_device_s({"tbr.occluder"}, {1}) == 0.0


def test_nested_spans_of_one_name_count_once_in_host_time():
    sp = S.collect(_events())
    assert sp.count({"tbr.plan"}) == 2
    assert sp.host_s({"tbr.plan"}) == pytest.approx(60e-6)
    assert sp.host_s({"tbr.plan", "tbr.tile_bounds"}) == pytest.approx(
        90e-6)
    assert sp.host_s({"tbr.plan", "tbr.tile_bounds"}, {1}) == (
        pytest.approx(30e-6))
    assert sp.count({"tbr.upload"}, {0}) == 0
    assert sp.count({"tbr.upload"}, {1}) == 1
    assert [s.iteration for s in sp.spans if s.name == "tbr.plan"] == [0, 0]


def test_a_trace_without_spans_reads_nothing():
    events = [e for e in _events()
              if not e["name"].startswith(S.PREFIX)]
    sp = S.collect(events)
    assert sp.spans == [] and len(sp.launches) == 3
    for names in ({"tbr.occluder"}, {"tbr.plan", "tbr.tile_bounds"}):
        assert sp.count(names) == 0
        assert sp.host_s(names) == 0.0
        assert sp.launched_device_s(names) == 0.0


def test_spans_change_no_attribution_of_device_time():
    with_spans = tracing.reduce_events(_events(), 2000e-6)
    without = tracing.reduce_events(
        [e for e in _events() if not e["name"].startswith(S.PREFIX)],
        2000e-6)
    names = [op.name for op in with_spans.ops]
    # aten work under a span keeps its operator's name; the port's kernel
    # keeps its kernel name and stays out of the glue
    assert names == ["aten::mul", "aten::add", "aten::cat",
                     "composite_kernel"]
    assert names == [op.name for op in without.ops]
    assert with_spans.aten_s() == pytest.approx(68e-6) == without.aten_s()
    assert with_spans.kernel_s(("composite_kernel",)) == pytest.approx(90e-6)
    assert with_spans.busy_s == without.busy_s


def test_an_idle_gap_is_named_after_the_innermost_span():
    tr = tracing.reduce_events(_events(), 2000e-6)
    gaps = dict(tr.top_gaps())
    # [0, 500): the midpoint 250 lies in the occluder's range
    assert gaps["tbr.occluder"] == pytest.approx(500e-6)
    assert "rmbench.render" not in gaps


def test_the_trace_keeps_the_spans_for_readers():
    tr = tracing.reduce_events(_events(), 2000e-6)
    sp = S.collect(_events())
    assert isinstance(tr.spans, S.Spans)
    assert tr.spans == sp
    for names in ({"tbr.occluder"}, {"tbr.lighting"}, {"tbr.plan"},
                  {"tbr.plan", "tbr.tile_bounds"}, {"tbr.upload"}):
        for its in (None, {0}, {1}):
            assert tr.spans.count(names, its) == sp.count(names, its)
            assert tr.spans.host_s(names, its) == sp.host_s(names, its)
            assert tr.spans.launched_device_s(names, its) == \
                sp.launched_device_s(names, its)
    assert tr.spans.launched_device_s({"tbr.occluder"}) == pytest.approx(
        50e-6)
