"""On the card: one short run of each cell through the entry point, as
the driver runs it, and the controls failing their limits. Skips without
a card (run on the H100: ``python -m pytest rmbench/tests -q -m cuda``)."""

import json
import subprocess
import sys
import time

import pytest
import _tiny

from rmbench import harness

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in harness.load_benchmark(_tiny.ROOT)["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_entry_point_run(card, name):
    proc = subprocess.run(
        [sys.executable, "rmbench/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=_tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    c = harness.Cell(harness.load_benchmark(_tiny.ROOT), name)
    r = harness.run_cell(c, 2**31 + 12, 2.0, False, card,
                         time.perf_counter(), control=True)
    assert r["correct"], r["checks"]
    assert any(r["numbers"]["control." + k] > v["limit"]
               for k, v in r["checks"].items())
