"""The readings the comparison's limits are set from: for each seed, one
short run of a cell with the program's numbers and, on the same work, the
lower-precision control's (and for the fit, a planted fault's), all in
one process.

    python3 rmbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--out chiprun_out/calibrate.jsonl]

Prints one JSON line per seed (``numbers``: the compared numbers, those
of the control under ``control.``, of the fault under ``fault_half.``).
Needs a CUDA card; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from rmbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        t0 = T0
        for seed in (int(s) for s in args.seeds.split(",")):
            r = harness.run_cell(cell, seed, args.seconds, False,
                                 torch.device("cuda", 0), t0, control=True)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "numbers": r["numbers"],
                               "metrics": r["metrics"],
                               "attempted": r["attempted"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            t0 = time.perf_counter()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
