"""A cell over several cards: one process per card, started by `run.py`.

Where a cell's ``chips`` is n > 1, `run.py` starts n workers
(:func:`spawn`), each ``run.py --worker <dir> <rank>``; rank r runs on
``cuda:r`` (on the CPU in tests). They meet on a file store in a
temporary directory under ``TMPDIR``, join the port's process group
through `system.join` (NCCL on the card, gloo on the CPU) and make its
mesh of one ``"slab"`` axis. The harness talks over two groups of its
own, each with a timeout (:data:`TIMEOUT_S`): one of the default backend
for the end-of-iteration flag, and a gloo one for barriers and gathers.

Timing (:class:`Ranks`): every rank runs the same warm-up, each warm-up
iteration ending as a timed one does; set-up ends at a barrier after
every rank's warm-up, on rank 0's clock from `run.py`'s start, the spawn
included (``perf_counter`` is the system's monotonic clock, shared by
every process). In each iteration every rank synchronises its own card,
then joins one all-reduce (max) of a 1-element device tensor that
carries rank 0's stop flag; rank 0 times the iteration to the end of that
collective, so a frame ends when the slowest card is done, and every
rank stops after the same iteration.

After the window each rank sends rank 0 its iteration count, memory peak,
traced busy seconds and, unless the configuration is sharded (where only
rank 0's frame is whole), its sampled frames. Rank 0 compares every
rank's frames with the reference on its own card while the others wait
at a barrier, and writes the result; `run.py` prints it once every
worker has exited with 0. Where a worker exits otherwise, or the run
outlasts its limit, the parent ends the others and prints no result.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

RUN = Path(__file__).resolve().parent / "run.py"
TIMEOUT_S = 300  # the harness's collectives and barriers
LIMIT_S = 1200  # the whole run beyond its window (the first run builds)
END_S = 10  # from SIGTERM to SIGKILL for a worker that is ended
FAILED = 4  # run.py's exit code where a rank fails or the run outlasts
PR_SET_PDEATHSIG = 1


def check_cell(cell, world: int) -> None:
    """Refuse, before any worker starts, a cell that cannot run on
    ``world`` ranks."""
    if cell.gen.loop != "frames":
        raise ValueError(f"a {cell.gen.loop} cell runs on one card")
    sharding = cell.config.get("sharding")
    if sharding:
        from .volumes import slab

        if sharding.get("axis") != "z":
            raise ValueError(f"sharding {sharding}: only along z")
        slab(cell.config["dims"], 0, world)


def spec(bench: dict, workload: str, seed: int, seconds: float,
         traced: bool, world: int, device: str, t0: float,
         config: dict | None = None, traffic: dict | None = None) -> dict:
    """What every worker reads: the run's arguments, and the cell as the
    benchmark dict, the workload's name and (for tests) the configuration
    and mix that replace the ones found by name."""
    return {"bench": bench, "workload": workload, "config": config,
            "traffic": traffic, "seed": int(seed), "seconds": float(seconds),
            "trace": bool(traced), "world": int(world), "device": device,
            "t0": t0, "parent": os.getpid()}


def die_with_parent(parent: int) -> None:
    """In a worker, first: be killed when the run's process ``parent``
    ends, however it ends; exit now if it already has."""
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                            signal.SIGKILL)
    if os.getppid() != parent:
        sys.exit(FAILED)


def spawn(run_spec: dict, command=None):
    """Run ``run_spec["world"]`` workers of one run and wait for them, at
    most :data:`LIMIT_S` beyond the window: (exit code, rank 0's result
    or None, the workers' pids). ``command`` is the worker's program
    (default ``python3 rmbench/run.py``), given ``--worker <dir> <rank>``."""
    world = int(run_spec["world"])
    command = list(command or [sys.executable, str(RUN)])
    limit_s = LIMIT_S + run_spec["seconds"]
    procs = []
    old = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory(prefix="rmbench-ranks-") as tmp:
        rundir = Path(tmp)
        (rundir / "spec.json").write_text(json.dumps(run_spec))
        try:
            signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
            for r in range(world):
                procs.append(subprocess.Popen(
                    command + ["--worker", str(rundir), str(r)],
                    env=dict(os.environ, LOCAL_RANK=str(r))))
            rc = _wait(procs, time.monotonic() + limit_s)
        finally:
            _end(procs)
            signal.signal(signal.SIGTERM, old)
        result = None
        if rc == 0:
            result = json.loads((rundir / "result.json").read_text())
    return rc, result, [p.pid for p in procs]


def _wait(procs, deadline: float) -> int:
    """0 once every worker has exited with 0; :data:`FAILED` as soon as
    one exits otherwise or the deadline passes."""
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                print(f"rmbench: rank {r} exited with {c}; ending the "
                      f"other ranks", file=sys.stderr)
                return FAILED
        if all(c == 0 for c in codes):
            return 0
        if time.monotonic() > deadline:
            print("rmbench: the ranks outlasted the run's limit; ending "
                  "them", file=sys.stderr)
            return FAILED
        time.sleep(0.05)


def _end(procs) -> None:
    """End every worker still running: SIGTERM, then SIGKILL after
    :data:`END_S`; wait for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    stop = time.monotonic() + END_S
    for p in procs:
        try:
            p.wait(timeout=max(stop - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class Ranks:
    """This worker's rank in the run: the port's group and mesh, and the
    harness's own collectives."""

    def __init__(self, rank: int, world: int, device, rundir: Path):
        from . import system

        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.mesh = system.join(world, rank, f"file://{rundir}/store",
                                self.device)
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        self.host = dist.new_group(backend="gloo", timeout=timeout)
        self.flags = dist.new_group(timeout=timeout)
        self.flag = torch.zeros(1, device=self.device)
        self.deadline = math.inf
        self.stop = False
        self.collective_s = []

    def open_window(self, seconds: float) -> float:
        """The window's start; rank 0 raises the stop flag once an
        iteration's card is done ``seconds`` after it."""
        start = time.perf_counter()
        self.deadline, self.collective_s = start + seconds, []
        return start

    def end_iteration(self, end: float) -> float:
        """The collective that ends an iteration whose card is done at
        ``end``: the stop flag, max over ranks; returns its end."""
        self.flag.fill_(float(self.rank == 0 and end >= self.deadline))
        dist.all_reduce(self.flag, op=dist.ReduceOp.MAX, group=self.flags)
        self.stop = bool(self.flag.item())
        done = time.perf_counter()
        self.collective_s.append(done - end)
        return done

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def gather(self, obj):
        """Every rank's ``obj`` on rank 0, in rank order; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.host)
        return out

    def close(self) -> None:
        """Wait for every rank (rank 0's check), then leave the group."""
        self.barrier()
        dist.destroy_process_group()
