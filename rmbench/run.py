"""Run one cell of the port's benchmark once: on the card this process
starts on, or for a cell of n > 1 chips in n worker processes, one per
card (`ranks.py`).

    python3 rmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``python3 -m rmbench.run`` works the same).
The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
with its limit, also printed as the last lines of standard error.

Exits with code 2, printing no result, when PyTorch finds no CUDA card
or fewer than the cell asks for, with code 3 when ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the run is over, and with
code 4 when a cell over several cards cannot run on them or a worker
fails (a worker that finds JAX loaded fails with 3); the other workers
are then ended.

``run.py --worker <dir> <rank>`` is one such worker, started by the run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

# the program's and its libraries' caches stay inside the checkout, at
# fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / ".rmbench_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")

BANNED = ("jax", "jaxlib", "flax", "tbraymarcherplugin_tpu")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``BANNED``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        return worker(Path(argv[1]), int(argv[2]))
    args = parse(argv)
    import torch

    from rmbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.Cell(bench, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rmbench: the cell needs {chips} CUDA card(s); PyTorch finds "
              f"{found}", file=sys.stderr)
        return 2
    if chips > 1:
        return run_spawned(bench, args, chips, "cuda")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    result["device"]["card"] = power_limit()
    return emit(result)


def emit(result: dict) -> int:
    """Print the result (0), or nothing where JAX is loaded here (3)."""
    found = banned_modules()
    if found:
        print(f"rmbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    line, notes = finish(result)
    print("\n".join(notes), file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


def run_spawned(bench: dict, args, world: int, device: str, config=None,
                traffic=None, command=None) -> int:
    """The cell ``args.workload`` in ``world`` worker processes
    (`ranks.spawn`), on ``cuda:0`` to ``cuda:<world-1>`` or, for tests, on
    the CPU; prints rank 0's result once every worker has exited with 0.
    ``config``, ``traffic`` (tests) replace the cell's own; ``command``
    replaces the worker's program."""
    from rmbench import harness, ranks

    cell = harness.Cell(bench, args.workload, config, traffic)
    try:
        ranks.check_cell(cell, world)
    except ValueError as e:
        print(f"rmbench: {e}", file=sys.stderr)
        return ranks.FAILED
    spec = ranks.spec(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), world, device, T0, config, traffic)
    rc, result, _ = ranks.spawn(spec, command)
    if rc != 0:
        return rc
    if device == "cuda":
        result["device"]["card"] = power_limit()
    return emit(result)


def worker(rundir: Path, rank: int) -> int:
    """Rank ``rank`` of a run that `run_spawned` started: the cell on
    ``cuda:<rank>`` (or the CPU), rank 0 writing the result; 3 where JAX
    is loaded here once the window has closed."""
    import torch

    from rmbench import harness, ranks

    spec = json.loads((rundir / "spec.json").read_text())
    ranks.die_with_parent(spec["parent"])
    world = int(spec["world"])
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the host's cores shared out between the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cell = harness.Cell(spec["bench"], spec["workload"], spec["config"],
                        spec["traffic"])
    me = ranks.Ranks(rank, world, device, rundir)
    result = harness.run_cell(cell, spec["seed"], spec["seconds"],
                              spec["trace"], device, spec["t0"], ranks=me)
    found = banned_modules()
    if found:
        print(f"rmbench: rank {rank}: JAX or the JAX package is loaded: "
              f"{found}", file=sys.stderr)
    elif rank == 0:
        (rundir / "result.json").write_text(json.dumps(result))
    me.close()
    return 3 if found else 0


def finish(result: dict):
    """(the result line, the last lines of standard error): the line
    keeps the contract's keys with ``checks`` last; standard error ends
    with the set-up's detail and each compared number beside its
    limit."""
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device", "breakdown")
            if k in result}
    line["checks"] = result["checks"]
    notes = [json.dumps(result["setup_detail"])]
    notes += [f"check {name} = {c['value']} (limit {c['limit']})"
              for name, c in result["checks"].items()]
    return line, notes


if __name__ == "__main__":
    sys.exit(main())
