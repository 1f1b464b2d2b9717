"""Run one cell of the port's benchmark once, on the card this process
starts on.

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
or fewer than the cell asks for, and with code 3 when ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the run is over.
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
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    result["device"]["card"] = power_limit()
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
