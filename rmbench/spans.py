"""The program's own spans in a torch.profiler trace.

The port opens a ``tbr.<layer>`` range (`utils/profiling.py::span`) at
each layer boundary of a frame, a rebuild and a fit step, and only while
a profiler records. In the Chrome trace they are ``user_annotation``
events on the host thread that opened them, on the clock of the device
operations. :func:`collect` keeps them, each with the iteration whose
``rmbench.iter.<i>`` range holds its start, and the device operations
linked to an ``aten::`` operator (`trace.py`'s attribution) with the
runtime call that launched them. Three readings:

- :meth:`Spans.host_s`: host seconds inside the spans of some names, the
  union per thread, so a span nested in one of the same name counts once;
- :meth:`Spans.count`: how many such spans opened (a span that opens only
  when its work runs counts that work: plans built, uploads made);
- :meth:`Spans.launched_device_s`: device seconds of the aten-linked
  operations whose launch, on the span's own thread, falls inside one of
  those spans (the torch glue a layer enqueues, wherever the device runs
  it later).

A trace of a program without spans gives no span: each reading is then
0 and a reader reports nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math

from .trace import DEVICE_CATS, ITER_PREFIX

PREFIX = "tbr."


@dataclasses.dataclass
class Span:
    name: str
    ts: float  # us
    end: float  # us
    tid: object  # the host thread
    iteration: int | None


@dataclasses.dataclass
class Launch:
    """A device operation linked to an ``aten::`` operator."""

    ts: float  # the launch's start on the host, us
    tid: object  # the launching thread
    dur: float  # on the device, us


@dataclasses.dataclass
class Spans:
    spans: list
    launches: list

    def _of(self, names, iterations):
        return [s for s in self.spans if s.name in names and (
            iterations is None or s.iteration in iterations)]

    def _merged(self, names, iterations):
        """{thread: the union of its spans named in ``names``, as sorted
        disjoint [start, end] intervals}."""
        out = collections.defaultdict(list)
        for s in sorted(self._of(names, iterations), key=lambda s: s.ts):
            ivs = out[s.tid]
            if ivs and s.ts <= ivs[-1][1]:
                ivs[-1][1] = max(ivs[-1][1], s.end)
            else:
                ivs.append([s.ts, s.end])
        return out

    def count(self, names, iterations=None) -> int:
        """Spans named in ``names`` (in ``iterations`` only, when given)."""
        return len(self._of(names, iterations))

    def host_s(self, names, iterations=None) -> float:
        """Host seconds inside spans named in ``names``: per thread, the
        length of the union of their intervals."""
        return sum(e - s for ivs in self._merged(names, iterations).values()
                   for s, e in ivs) / 1e6

    def launched_device_s(self, names, iterations=None) -> float:
        """Device seconds of the aten-linked operations launched, on the
        span's thread, inside a span named in ``names``."""
        merged = self._merged(names, iterations)
        total = 0.0
        for op in self.launches:
            ivs = merged.get(op.tid)
            if not ivs:
                continue
            k = bisect.bisect_right(ivs, [op.ts, math.inf]) - 1
            if k >= 0 and op.ts <= ivs[k][1]:
                total += op.dur
        return total / 1e6


def collect(events) -> Spans:
    """The ``tbr.`` spans and the aten-linked launches of Chrome trace
    events (those `trace.reduce_events` reads)."""
    aten_ext, runtime, iters, raw = set(), {}, [], []
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args", {})
        name = ev.get("name", "?")
        if cat == "cpu_op" and name.startswith("aten::"):
            ext = args.get("External id")
            if ext is not None:
                aten_ext.add(ext)
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            runtime[args["correlation"]] = (float(ev["ts"]), ev.get("tid"))
        if cat == "user_annotation" and "dur" in ev:
            s = float(ev["ts"])
            if name.startswith(ITER_PREFIX):
                iters.append((s, s + float(ev["dur"]),
                              int(name[len(ITER_PREFIX):])))
            elif name.startswith(PREFIX):
                raw.append((name, s, s + float(ev["dur"]), ev.get("tid")))
    iters.sort()
    starts = [s for s, _, _ in iters]

    def iteration_at(ts):
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and ts <= iters[k][1]:
            return iters[k][2]
        return None

    spans = [Span(n, s, e, tid, iteration_at(s)) for n, s, e, tid in raw]
    launches = []
    for ev in events:
        args = ev.get("args", {})
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        if args.get("External id") not in aten_ext:
            continue
        launch = runtime.get(args.get("correlation"))
        if launch is not None:
            launches.append(Launch(launch[0], launch[1], float(ev["dur"])))
    return Spans(sorted(spans, key=lambda s: s.ts), launches)
