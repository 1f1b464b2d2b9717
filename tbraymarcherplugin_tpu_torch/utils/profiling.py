"""Profiling: spans on the profiler's clock, phase bookmarks, device traces.

Counterpart of `tbraymarcherplugin_tpu/utils/profiling.py`, after the
reference's profiling mechanisms:

- :func:`span`: a named host range around one layer's work, named by the
  ``tbr.`` constants below. While a `torch.profiler` records, it is a
  `torch.profiler.record_function` range, which lands in the profiler's
  trace on the clock of the device activity it launches; otherwise it is
  one shared null context, so that a span costs one check of the
  profiler's state.
- :class:`PhaseTracer` <- the Unreal Insights `TRACE_BOOKMARK` phases of
  `APerformanceTest1` (`PerformanceTest1.cpp:51-208`): named phases with
  frame counts, reported as the JAX package's JSON.
- :func:`device_trace` <- `SCOPED_GPU_STAT` / draw events
  (`LightingShaders.cpp:24-30`): a `torch.profiler` trace (CPU and, where
  there is a card, CUDA activity) written to ``log_dir`` as a Chrome trace
  (`chrome://tracing`, Perfetto), with the block under a named range. It
  is how an operator gets the spans: a viewer or CLI frame rendered inside
  ``device_trace(log_dir)`` writes them beside the kernels they launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# The spans (`span`) at the layer boundaries of a frame, a rebuild and a
# fit step. Those marked "when" open only when their work runs, so that
# their count in a trace is the count of that work.
CAMERA = "tbr.camera"  # a viewer's per-frame camera, Camera.look_at
RENDER = "tbr.render"  # Renderer.render (args: its render count)
LIGHTING = "tbr.lighting"  # ensure_lighting, when it rebuilds or moves a light
OCCLUDER = "tbr.occluder"  # one face's occluder opacity field
LIGHT_SCAN = "tbr.light_scan"  # one face's scan, K4 (args: the face)
OCCUPANCY = "tbr.occupancy"  # the occupancy grid, when it is built
PLAN = "tbr.plan"  # the host shear-warp plan, when the cache misses
TILE_BOUNDS = "tbr.tile_bounds"  # K1's tile plane bounds, when computed
PRESHEAR = "tbr.preshear"  # the pre-shear of the volume and light planes
COMPOSITE = "tbr.composite"  # K1
WARP = "tbr.warp"  # the screen warp, K2
RAYS = "tbr.rays"  # a march frame's rays and jitter
MARCH = "tbr.march"  # K9
UPLOAD = "tbr.upload"  # a host-to-device copy, when one is made
SCENE = "tbr.scene"  # models.pipeline.render_lit_scene
COMPOSITE_BWD = "tbr.composite_bwd"  # K5
LIGHT_SCAN_BWD = "tbr.light_scan_bwd"  # K7
TF_ALPHA_BWD = "tbr.tf_alpha_bwd"  # K8
WARP_BWD = "tbr.warp_bwd"  # K6
PRESHEAR_BWD = "tbr.preshear_bwd"  # K12's adjoint
# a slab-sharded Renderer (parallel/): each span's args end in the bytes
# this rank sent
HALO = "tbr.halo"  # the volume's halo planes, when exchanged
LIGHT_RING = "tbr.light_ring"  # a Z face's carry, the upstream wait too
LIGHT_HALO = "tbr.light_halo"  # an X or Y face's light halo columns
PLANE_EXCHANGE = "tbr.plane_exchange"  # the partial planes' reduce-scatter
BAND_GATHER = "tbr.band_gather"  # the column bands to rank 0

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A ``record_function(name, str(args))`` range while a
    `torch.profiler` records; otherwise the one shared null context, with
    nothing built and ``args`` not formatted."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name, None if args is None else str(args))


class PhaseTracer:
    """Named benchmark phases with frame statistics (the bookmark model).
    A phase's time is the host's clock: a caller timing device work
    synchronizes before the phase ends."""

    def __init__(self):
        self.phases: List[dict] = []
        self._current: Optional[dict] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        rec = {"name": name, "frames": 0, "start": time.perf_counter()}
        self._current = rec
        try:
            yield self
        finally:
            rec["seconds"] = time.perf_counter() - rec["start"]
            del rec["start"]
            if rec["frames"]:
                rec["ms_per_frame"] = 1000.0 * rec["seconds"] / rec["frames"]
            self.phases.append(rec)
            self._current = None

    def frame(self, n: int = 1) -> None:
        """Count a frame toward the active phase (nothing outside a phase,
        e.g. a warm-up frame)."""
        if self._current is not None:
            self._current["frames"] += n

    def report(self) -> str:
        return json.dumps(self.phases, indent=2)

    def summary(self) -> dict:
        return {
            p["name"]: round(p.get("ms_per_frame", p["seconds"] * 1000.0), 3)
            for p in self.phases
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, name: str = "tbraymarcher"):
    """Trace a block with `torch.profiler` and write it to ``log_dir`` as
    ``<name>.pt.trace.json`` (Chrome trace format). With no ``log_dir`` the
    block only gets a named range, which shows in any enclosing trace."""
    if log_dir is None:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))
