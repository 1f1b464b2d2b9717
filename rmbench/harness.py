"""One run of one cell: set-up, the measured window (or the traced one),
the comparison with the reference, and the result's JSON object.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (read by `generator.py`), the
limits of its comparison in ``limits/<cell>.json``, each per-layer
metric's reader in ``metrics/<metric>.py`` (or, for a name ``<base>.<part>``
without a file of its own, ``metrics/<base>.py``), the configuration's
volume in ``volumes/<volume>.py`` and its reference in
``reference/<reference>.py`` (default ``frame``).

A frames cell renders one frame per iteration through the viewer's
`Renderer` (the setters of the window, the clip plane and the lights,
then ``render``, then ``torch.cuda.synchronize()``); a fit cell takes one optimizer step per
iteration. The window runs iterations until ``seconds`` have passed; a
traced run instead runs the mix's ``trace_iterations`` under
`torch.profiler`.

A frames cell on several cards runs this in one process per card, each
with its :class:`ranks.Ranks` (`ranks.py`: the timing across cards and
how the ranks' results are joined).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from . import check, generator, system, volumes
from . import trace as tracing
from .reference import common as RC
from .reference import fit as RFIT
from .reference import frame as RF
from .reference import lighting as RL
from .reference import scene as RS

HERE = Path(__file__).resolve().parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return _load_json(root / "BENCHMARK.json")


def load_config(name: str) -> dict:
    return _load_json(HERE / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return _load_json(HERE / "traffic" / f"{name}.json")


def load_reference(config: dict):
    """The reference module the configuration names (``reference``,
    ``reference/<name>.py``; default ``frame``): its ``illumination``,
    ``plan`` and ``frame`` are what the check calls."""
    name = config.get("reference", "frame")
    if not (HERE / "reference" / f"{name}.py").exists():
        raise KeyError(f"no reference {name!r}: rmbench/reference/{name}.py")
    return importlib.import_module(f"{__package__}.reference.{name}")


def metric_file(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    name ``<base>.<part>`` (one quantity split by the end-to-end metric it
    moves) without a file of its own, ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return path


def load_metric(name: str):
    """The reader module of the per-layer metric ``name``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "rmbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix and
    metrics."""

    def __init__(self, bench: dict, name: str, config: dict | None = None,
                 traffic: dict | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; choose {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        # a test may run a cell's mix on a smaller configuration
        config = config or load_config(self.workload["config"])
        self.traffic = traffic or load_traffic(self.workload["traffic"])
        # the renderer's options as this cell runs them: the mix's over
        # the configuration's
        self.config = dict(config, renderer=generator.renderer_options(
            config, self.traffic))
        self.gen = generator.Generator(self.config, self.traffic)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Samples:
    """The frames kept for the comparison: a reservoir of ``k`` drawn
    with the seed's generator from every frame the window finished, and
    the newest frame that rebuilt the illumination (the longest kind)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.n = k, rng, 0
        self.kept, self.key = [], None

    def offer(self, i: int, render_index: int, img, rebuilt: bool) -> None:
        """Keep iteration ``i``'s frame (the renderer's ``render_index``-th
        render) if the draw says so; ``rebuilt``: it rebuilt the
        illumination."""
        self.n += 1
        if len(self.kept) < self.k:
            self.kept.append((i, render_index, img.clone()))
        else:
            j = int(self.rng.integers(self.n))
            if j < self.k:
                self.kept[j] = (i, render_index, img.clone())
        if rebuilt:
            self.key = (i, render_index, img.clone())

    def items(self):
        out = {i: (i, r, img) for i, r, img in self.kept}
        if self.key is not None:
            out[self.key[0]] = self.key
        return [out[i] for i in sorted(out)]


def reference_scene(config: dict, volume, table, state,
                    jitter: bool) -> RF.Scene:
    scale = generator.world_scale(config)
    clip = (RS.ClipPlane.disabled() if state.clip is None
            else RS.ClipPlane.create(*state.clip))
    return RF.Scene(
        volume=volume, table=table,
        window=(state.window_center, state.window_width, 1.0, 1.0),
        transform=RS.VolumeTransform.create(scale=tuple(scale)),
        lights=state.lights,
        clip=clip, width=int(config["width"]), height=int(config["height"]),
        step_count=int(config["step_count"]), jitter=jitter,
        early_termination=config["renderer"]["early_termination"])


def reference_camera(state):
    return RS.Camera.look_at(state.position, state.target,
                             fov_degrees=state.fov_deg)


def _quantile(values, q: float) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        int(round(q * 100)) - 1]


class Run:
    """The state of one run that the metric readers read."""

    def __init__(self, cell: Cell, device):
        self.device = torch.device(device)
        self.config = cell.config
        self.trace = None
        self.host_s = []
        self.counts = {}
        self.iterations = 0
        self.rebuilds = 0
        self.light_updates = 0
        dims = tuple(self.config["dims"])
        self.volume_voxels = int(np.prod(dims))
        self.pixels = int(self.config["width"]) * int(self.config["height"])
        self.plane_bytes = 2 if self.config["precision"][
            "frame_planes"] == "bfloat16" else 4
        self.fit_plane_bytes = 2 if self.config["precision"][
            "fit_planes"] == "bfloat16" else 4
        scale = generator.world_scale(self.config)
        transform = RS.VolumeTransform.create(scale=tuple(scale))
        self.faces = 0
        for li in self.config["lights"]:
            d = transform.local_light_direction(
                RS.DirLight.create(li["direction"], li["intensity"]))
            self.faces += sum(w > 0 for w in
                              RL.local_light_major_axes(d).weights)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, control: bool = False, ranks=None) -> dict | None:
    """One run; ``t0`` is the process's start on the host clock.
    ``control`` (`calibrate.py`, never the benchmark's runs) also reads
    the lower-precision control's numbers on the same work, under
    ``result["numbers"]``. ``ranks``: this process's `ranks.Ranks` in a
    run over several cards (frames cells only), where rank 0 returns the
    result and the others None."""
    if cell.gen.loop == "frames":
        return _run_frames(cell, seed, seconds, traced, device, t0, control,
                           ranks)
    if ranks is not None:
        raise ValueError("a fit cell runs on one card")
    return _run_fit(cell, seed, seconds, traced, device, t0, control)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _inputs(config: dict, seed: int, device, ranks=None):
    """The volume the configuration names (``volumes/<volume>.py``), made
    on ``device`` from the seed (a sharded configuration's rank: its Z
    slab), and its TF table."""
    z = None
    if ranks is not None and config.get("sharding"):
        z = volumes.slab(config["dims"], ranks.rank, ranks.world)
    volume = volumes.load(config["volume"]).make(config["dims"], seed,
                                                 device, z=z)
    table = RC.tf_table(config["tf"], device)
    return volume, table


def _run_frames(cell, seed, seconds, traced, device, t0, control=False,
                ranks=None):
    run = Run(cell, device)
    cfg, gen = cell.config, cell.gen
    sharded = ranks is not None and bool(cfg.get("sharding"))
    compile_s = system.load_kernels(device)
    volume, table = _inputs(cfg, seed, device, ranks)
    viewer = system.Viewer(cfg, volume, table, device,
                           mesh=None if ranks is None else ranks.mesh)
    renders = 0
    for i in cell.traffic["warmup_iterations"]:
        st = gen.state(i)
        viewer.apply(st)
        viewer.render(st)
        renders += 1
        if ranks is not None:
            sync(device)
            ranks.end_iteration(time.perf_counter())
    sync(device)
    if ranks is not None:
        ranks.barrier()
    setup_s = time.perf_counter() - t0
    # a sharded configuration's frame is whole on rank 0 alone
    keep = not sharded or ranks.rank == 0
    samples = Samples(int(cell.traffic["samples"]),
                      np.random.default_rng(seed))
    lat = []

    def iteration(i, rf):
        nonlocal renders
        st = gen.state(i)
        ta = time.perf_counter()
        moved = viewer.light_updates
        with rf("rmbench.apply"):
            rebuilt = viewer.apply(st)
        run.light_updates += viewer.light_updates - moved
        tb = time.perf_counter()
        with rf("rmbench.render"):
            img = viewer.render(st)
        tc = time.perf_counter()
        with rf("rmbench.sync"):
            sync(device)
        td = time.perf_counter()
        if ranks is not None:
            with rf("rmbench.collective"):
                td = ranks.end_iteration(td)
        lat.append(td - ta)
        run.host_s.append(tc - tb)
        if keep:
            samples.offer(i, renders, img, rebuilt)
        run.rebuilds += rebuilt
        renders += 1
        return td

    window_s = _window(run, iteration, seconds, traced,
                       int(cell.traffic["trace_iterations"]), device, ranks)
    run.iterations = len(lat)
    peak = _peak(device)
    del viewer
    _free(device)

    others = []
    if ranks is not None:
        everyone = ranks.gather({
            "iterations": run.iterations, "peak": peak,
            "busy_s": run.trace.busy_s if traced else None,
            "frames": ([(i, r, img.cpu()) for i, r, img in samples.items()]
                       if keep and ranks.rank else [])})
        if ranks.rank != 0:
            return None
        others = [e["frames"] for e in everyone[1:] if e["frames"]]
        if sharded:  # the reference makes the volume itself, in blocks
            del volume
            _free(device)
            volume = volumes.VolumeSource(cfg["volume"], tuple(cfg["dims"]),
                                          int(seed))
    numbers, failed = _check_frames(run, cell, volume, table, samples,
                                    traced, control, others)
    out = _result(cell, run, setup_s, lat, numbers, failed, peak,
                  compile_s, traced, window_s)
    if ranks is not None:
        _join_ranks(out, ranks, everyone, traced)
    return out


def _join_ranks(out: dict, ranks, everyone: list, traced: bool) -> None:
    """Rank 0's result over every rank: the fullest card's peak (and each
    card's), the busy seconds averaged over the cards, and in the run's
    detail each rank's iterations and the mean end-of-iteration
    collective."""
    dev = out["device"]
    dev["count"] = ranks.world
    dev["memory_peak_bytes_by_rank"] = [e["peak"] for e in everyone]
    dev["memory_peak_bytes"] = max(dev["memory_peak_bytes_by_rank"])
    if traced and "busy_s" in dev:
        dev["busy_s_by_rank"] = [e["busy_s"] for e in everyone]
        dev["busy_s"] = sum(dev["busy_s_by_rank"]) / ranks.world
    col = ranks.collective_s
    out["setup_detail"].update({
        "iterations_by_rank": [e["iterations"] for e in everyone],
        "collective_ms_mean": sum(col) / len(col) * 1e3 if col else None})


def _window(run, iteration, seconds, traced, trace_iterations, device,
            ranks=None):
    """The measured window's seconds: ``iteration(i, ranges)`` (which
    returns its end on the host clock) until ``seconds`` have passed (on
    several cards, until rank 0's stop flag comes back); or, traced,
    ``trace_iterations`` of them under the profiler, each in an
    ``rmbench.iter.<i>`` range, the trace read into ``run.trace``."""
    if not traced:
        start = (time.perf_counter() if ranks is None
                 else ranks.open_window(seconds))
        i = 0
        while True:
            end = iteration(i, lambda name: contextlib.nullcontext())
            i += 1
            if (end - start >= seconds if ranks is None else ranks.stop):
                return end - start
    from torch.profiler import record_function

    with _profiler(device) as prof:
        start = time.perf_counter()
        if ranks is not None:
            ranks.open_window(math.inf)
        for i in range(trace_iterations):
            with record_function(f"{tracing.ITER_PREFIX}{i}"):
                end = iteration(i, record_function)
    run.trace = tracing.read_profile(prof, end - start)
    return end - start


# The controls: the reference in the precision next below the one the
# configuration states for what a frame stores: float8 (e4m3) planes for a
# shear-warp frame's bfloat16 planes, a bfloat16 volume and light volume
# for a march frame's float32 ones.
CONTROL_PLANES = torch.float8_e4m3fn
CONTROL_MARCH_STORAGE = torch.bfloat16


def _frame_numbers(img, ref, ref_stated) -> dict:
    """A frame's compared numbers against the float32 reference ``ref``:
    ``frame_rel_l2``, ``frame_trimmed_err`` and, where ``ref_stated`` (the
    reference with the planes in the configuration's plane type) is given,
    ``frame_err_ratio``."""
    out = {"frame_rel_l2": check.rel_l2(img, ref),
           "frame_trimmed_err": check.trimmed_err(img, ref)}
    if ref_stated is not None:
        out["frame_err_ratio"] = check.err_ratio(img, ref, ref_stated)
    return out


def _check_frames(run, cell, volume, table, samples, traced, control=False,
                  others=()):
    """The reference's frames of the sampled iterations: the compared
    numbers (each the worst over the sampled frames), and in a traced run
    the work counts the rooflines read; with ``control`` also the
    control's numbers on the same frames (each the least). ``others``:
    the other ranks' sampled frames of the same iterations, each held to
    the same reference; a frame fails where any rank's fails. ``volume``
    is a tensor, or for a sharded configuration a
    `volumes.VolumeSource` that the reference makes blocks from."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, gen = cell.config, cell.gen
    ref_mod = load_reference(cfg)
    limits = check.load_limits(cell.name)
    planes = getattr(torch, cfg["precision"]["frame_planes"])
    per_frame, controls, lights = [], [], {}
    other_imgs = [{i: img for i, _, img in frames} for frames in others]
    with torch.no_grad():
        for i, render_index, img in samples.items():
            st = gen.state(i)
            scene = reference_scene(cfg, volume, table, st,
                                    cfg["renderer"]["jitter"])
            key = (st.window_center, st.window_width, st.clip, st.lights)
            if key not in lights:
                lights.clear()
                lights[key] = ref_mod.illumination(scene)
            stats = {} if traced else None
            cam = reference_camera(st)
            p = ref_mod.plan(scene, cam)
            ref = ref_mod.frame(scene, cam, lights[key], render_index,
                                stats=stats)
            stated = None
            if p is not None:
                stated = ref_mod.frame(scene, cam, lights[key], render_index,
                                       plane_dtype=planes)
            # one entry a frame: the worst of every rank's numbers
            nums = [_frame_numbers(x.to(ref.device), ref, stated)
                    for x in [img] + [o[i] for o in other_imgs]]
            per_frame.append({k: max(n[k] for n in nums) for k in nums[0]})
            if control:
                low = ref_mod.frame(scene, cam, lights[key], render_index,
                                    plane_dtype=CONTROL_PLANES,
                                    storage_dtype=CONTROL_MARCH_STORAGE)
                controls.append(_frame_numbers(low, ref, stated))
                del low
            if traced:
                stats["kind"] = "march" if p is None else "composite"
                if p is not None:
                    stats["n1"], stats["n2"] = p.n1, p.n2
                run.counts[i] = stats
            del ref, stated
    numbers = {k: max(f[k] for f in per_frame if k in f)
               for k in {k for f in per_frame for k in f}}
    for k in {k for f in controls for k in f}:
        numbers["control." + k] = min(f[k] for f in controls if k in f)
    failed = sum(any(not f.get(k, 0.0) <= v for k, v in limits.items())
                 for f in per_frame)
    return numbers, failed


def _fit_record(fitter, trf) -> "RFIT.Record":
    """The checked steps of a fit step object, recorded."""
    rec = RFIT.Record(fitter.leaves)
    for k in range(int(trf["checked_steps"])):
        loss = fitter.step()
        rec.after_step(k, float(loss), fitter.opt, fitter.leaves,
                       float(trf["betas"][0]))
    return rec


def _fit_controls(cfg, trf, volume, table, target, st, device) -> dict:
    """The checked steps of the control, the program's own bfloat16-plane
    path, and of a planted fault, half of the image's rows left out of
    the loss (the mean taken over the rest)."""
    out = {}
    low = dict(cfg, precision=dict(cfg["precision"], fit_planes="bfloat16"))
    for tag in ("control", "fault_half"):
        c = low if tag == "control" else cfg
        f = system.FitStep(c, trf, volume, table, target, st, device)
        if tag == "fault_half":
            image_loss, smooth = f.loss_terms
            h = f.height // 2
            f.loss_terms = (lambda img, tgt: image_loss(img[:h], tgt[:h]),
                            smooth)
        out[tag] = _fit_record(f, trf)
        del f
        _free(device)
    return out


def _run_fit(cell, seed, seconds, traced, device, t0, control=False):
    run = Run(cell, device)
    cfg, trf, gen = cell.config, cell.traffic, cell.gen
    compile_s = system.load_kernels(device)
    volume, table = _inputs(cfg, seed, device)
    st = gen.state(0)
    scene = reference_scene(cfg, volume, table, st, False)
    # the target is the reference's frame at the configuration's window:
    # an input of the fit that the program does not make, so neither its
    # seconds nor its memory count as the program's
    sync(device)
    ta = time.perf_counter()
    with torch.no_grad():
        target = RFIT.target_image(scene, reference_camera(st))
    sync(device)
    target_s = time.perf_counter() - ta
    _free(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fitter = system.FitStep(cfg, trf, volume, table, target, st, device)
    early = _fit_record(fitter, trf)
    sync(device)
    setup_s = time.perf_counter() - t0 - target_s
    lat = []

    def iteration(i, rf):
        ta = time.perf_counter()
        with rf("rmbench.step"):
            fitter.step()
        tb = time.perf_counter()
        with rf("rmbench.sync"):
            sync(device)
        td = time.perf_counter()
        lat.append(td - ta)
        run.host_s.append(tb - ta)
        return td

    window_s = _window(run, iteration, seconds, traced,
                       int(trf["trace_iterations"]), device)
    run.iterations = len(lat)
    peak = _peak(device)
    plan = fitter.plan
    del fitter
    _free(device)
    others = (_fit_controls(cfg, trf, volume, table, target, st, device)
              if control else {})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {} if traced else None
    ref = RFIT.reference_steps(scene, reference_camera(st), target, trf,
                               int(trf["checked_steps"]), stats=stats)
    numbers = RFIT.compare(early, ref)
    for tag, rec in others.items():
        for k, v in RFIT.compare(rec, ref).items():
            numbers[f"{tag}.{k}"] = v
    if traced:
        stats["n1"], stats["n2"], stats["planes"] = plan.n1, plan.n2, plan.k
        run.counts["fit"] = stats
    limits = check.load_limits(cell.name)
    failed = sum(not (numbers.get(k) is not None and numbers[k] <= v)
                 for k, v in limits.items())
    return _result(cell, run, setup_s, lat, numbers, failed, peak,
                   compile_s, traced, window_s)


def end_to_end_value(name: str, setup_s: float, window_s: float,
                     lat: list) -> float:
    """An end-to-end metric by its name: ``setup_s``; a name ending in
    ``_p95`` the 95th percentile of the iterations' latencies in ms;
    any other the window's wall time over the iterations it finished, in
    ms (``frame_ms``, ``rebuild_frame_ms``, ``step_ms``)."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_p95"):
        return _quantile(lat, 0.95) * 1e3
    return window_s / len(lat) * 1e3


def _result(cell, run, setup_s, lat, numbers, failed, peak, compile_s,
            traced, window_s) -> dict:
    ok, checks = check.judge(numbers, check.load_limits(cell.name))
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": end_to_end_value(m["name"], setup_s, window_s, lat),
                "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(ok), "attempted": run.iterations,
           "failed": int(failed), "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.top_gaps()}
    thirds = [lat[k * len(lat) // 3:(k + 1) * len(lat) // 3]
              for k in range(3)]
    out["setup_detail"] = {
        "setup_s": setup_s, "compile_s": compile_s,
        "window_s": window_s,
        # the mean iteration of each third of the window: a drift within
        # the run shows here, one between runs does not
        "thirds_ms": [sum(t) / len(t) * 1e3 if t else None
                      for t in thirds],
        "host_ms_mean": (sum(run.host_s) / len(run.host_s) * 1e3
                         if run.host_s else None)}
    out["checks"] = checks
    out["numbers"] = numbers
    return out
