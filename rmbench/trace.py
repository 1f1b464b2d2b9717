"""Reading a torch.profiler trace of the traced window.

The busy-union and the attribution of device operations to their
``aten::`` operator are copied from
`tbraymarcherplugin_tpu_torch/tools/profile_frame.py` (`_busy_us`,
`device_breakdown`, `_short`): busy is the union of the kernel, memcpy and
memset intervals; a device operation that the profiler links to an
``aten::`` operator is named after it, the port's own kernels (launched
through ctypes, so linked to no operator or to the autograd node that
launched them) keep their kernel names. Added here:
each device operation is given the iteration whose host range
(``rmbench.iter``) launched it, each idle gap between device
operations is named after what the host was doing in it, the
program's own spans are kept (`spans.py`) for the metrics that read them,
and the device operations that the harness itself launches in its
``rmbench.collective`` range (the stop flag's all-reduce of a run over
several cards, whose kernel spins while it waits for the slowest card)
are left out of the operations and of the busy time: they are not the
program's work.

The trace is written to a temporary directory under ``TMPDIR`` and
deleted once read.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
ITER_PREFIX = "rmbench.iter."
HARNESS_RANGE = "rmbench.collective"


def short_name(name: str, n: int = 72) -> str:
    """A kernel's name without ``void``, its parameters and its template
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    name = "".join(out)
    return name if len(name) <= n else name[: n - 3] + "..."


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclasses.dataclass
class DeviceOp:
    name: str  # the aten operator, or the kernel's short name
    kernel: str  # the kernel's short name
    aten: bool  # linked to an aten operator (torch's own work)
    ts: float  # us
    dur: float  # us
    iteration: int | None


@dataclasses.dataclass
class Trace:
    ops: list
    busy_s: float
    window_s: float
    gaps: list  # [(host activity, seconds)]
    spans: object  # the program's spans, `spans.Spans`

    def kernel_s(self, kernels, iterations=None) -> float:
        """Device seconds of the kernels whose short name is in
        ``kernels`` (in ``iterations`` only, when given)."""
        return sum(op.dur for op in self.ops if op.kernel in kernels and (
            iterations is None or op.iteration in iterations)) / 1e6

    def aten_s(self) -> float:
        """Device seconds of operations linked to an aten operator."""
        return sum(op.dur for op in self.ops if op.aten) / 1e6

    def top_ops(self, n: int = 10):
        by = collections.Counter()
        for op in self.ops:
            by[op.name] += op.dur / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    def top_gaps(self, n: int = 10):
        by = collections.Counter()
        for name, s in self.gaps:
            by[name] += s
        return [[k, v] for k, v in by.most_common(n)]


def read_profile(prof, window_s: float) -> Trace:
    """The :class:`Trace` of a finished `torch.profiler.profile`."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return reduce_events(events, window_s)


def reduce_events(events, window_s: float) -> Trace:
    """Reduce Chrome trace events to a :class:`Trace`."""
    from .spans import collect  # spans.py reads this module's names

    ops_by_ext, launch_ts, iters, host, own = {}, {}, [], [], []
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args", {})
        if cat == "cpu_op":
            ext = args.get("External id")
            if ext is not None:
                ops_by_ext[ext] = ev.get("name", "?")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = float(ev["ts"])
        if cat in HOST_CATS and "dur" in ev:
            name = ev.get("name", "?")
            s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
            if cat == "user_annotation" and name.startswith(ITER_PREFIX):
                iters.append((s, e, int(name[len(ITER_PREFIX):])))
            else:
                host.append((s, e, name))
                if cat == "user_annotation" and name == HARNESS_RANGE:
                    own.append((s, e))
    iters.sort()
    starts = [s for s, _, _ in iters]
    own.sort()
    own_starts = [s for s, _ in own]

    def harness_launch(ts):
        k = bisect.bisect_right(own_starts, ts) - 1
        return k >= 0 and ts <= own[k][1]

    def iteration_at(ts):
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and ts <= iters[k][1]:
            return iters[k][2]
        return None

    ops, spans = [], []
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        args = ev.get("args", {})
        lts = launch_ts.get(args.get("correlation"))
        if lts is not None and harness_launch(lts):
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        spans.append((ts, ts + dur))
        kernel = short_name(ev.get("name", "?"))
        # the innermost CPU operator the profiler links the operation to:
        # torch's own work sits under an aten:: operator; the port's
        # kernels sit under none, or under an autograd node
        # (``_FusedCompositeBackward``), and keep their kernel names
        linked = ops_by_ext.get(args.get("External id")) or ""
        aten = linked.startswith("aten::")
        ops.append(DeviceOp(linked if aten else kernel, kernel, aten, ts,
                            dur, None if lts is None else iteration_at(lts)))
    return Trace(ops, busy_us(spans) / 1e6, window_s,
                 _gaps(spans, iters, host), collect(events))


def _gaps(spans, iters, host):
    """[(what the host was doing, seconds)] for each idle interval of the
    device between the traced window's first iteration's start and its
    last's end: the innermost host operator or range that covers the
    gap's midpoint."""
    if not iters:
        return []
    lo, hi = iters[0][0], max(e for _, e, _ in iters)
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    host.sort()
    hstarts = [hs for hs, _, _ in host]
    out = []
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        name = "host outside any operator"
        # nested ranges: the covering one that starts last is innermost
        for k in range(bisect.bisect_right(hstarts, mid) - 1, -1, -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        out.append((name, (e - s) / 1e6))
    return out
