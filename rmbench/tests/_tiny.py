"""Tiny configurations for CPU tests: a cell's mix on a small volume and
screen, through the port's plain paths."""

import time
from pathlib import Path

from rmbench import harness

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return harness.load_benchmark(ROOT)


def cell(name, dims=None, width=64, height=40, steps=24, trace_iters=8):
    b = bench()
    c0 = harness.Cell(b, name)
    if dims is None:
        dims = [24, 20, 16] if "luna" in name else [24, 24, 24]
    cfg = dict(c0.config, dims=dims, width=width, height=height,
               step_count=steps)
    trf = dict(c0.traffic)
    trf["trace_iterations"] = min(trf["trace_iterations"], trace_iters)
    return harness.Cell(b, name, cfg, trf)


def run(c, seed=2**31 + 5, seconds=0.3, traced=False, control=False):
    return harness.run_cell(c, seed, seconds, traced, "cpu",
                            time.perf_counter(), control=control)
