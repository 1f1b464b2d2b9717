"""A cell over several ranks on the CPU, over gloo, through `run.py`'s own
spawn (`run.run_spawned`, one worker process a rank, `ranks.py`), at a
tiny size: one result line from rank 0 with every rank's frames held to
the reference, the same iterations on every rank, a planted fault ending
every worker with no line, a sharded configuration handing each rank its
Z slab with the mesh and the whole volume's dims, and a one-chip cell
that starts no process and builds no group."""

import json
import subprocess
import sys
import time
import types

import pytest
import torch
import _tiny

from rmbench import harness, ranks
from rmbench import run as rmrun

WORKER = [sys.executable, str(_tiny.ROOT / "rmbench/tests/_rank_worker.py")]
SEED = 2**31 + 21


def _tiny_orbit(**extra):
    c = _tiny.cell("ct256_bone.orbit", trace_iters=3)
    cfg = dict(harness.load_config("ct256_bone"), **extra,
               dims=c.config["dims"], width=c.config["width"],
               height=c.config["height"], step_count=c.config["step_count"])
    return cfg, c.traffic


def _run(capfd, world, plant="none", seconds=0.8, traced=False, **extra):
    cfg, trf = _tiny_orbit(**extra)
    args = types.SimpleNamespace(workload="ct256_bone.orbit", seed=SEED,
                                 seconds=seconds, trace=int(traced))
    t = time.monotonic()
    rc = rmrun.run_spawned(_tiny.bench(), args, world, "cpu", cfg, trf,
                           WORKER + [plant])
    elapsed = time.monotonic() - t
    out, err = capfd.readouterr()
    lines = [json.loads(x) for x in out.splitlines()
             if x.startswith("{") and '"correct"' in x]
    detail = [json.loads(x) for x in err.splitlines()
              if x.startswith('{"setup_s"')]
    return rc, lines, detail, err, elapsed


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_runs_the_viewer_and_rank_0_prints_one_line(capfd,
                                                               world):
    rc, lines, detail, err, _ = _run(capfd, world)
    assert rc == 0, err[-3000:]
    assert len(lines) == 1
    line = lines[0]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == world
    assert len(line["device"]["memory_peak_bytes_by_rank"]) == world
    its = detail[-1]["iterations_by_rank"]
    assert its == [line["attempted"]] * world and line["attempted"] >= 2
    assert detail[-1]["collective_ms_mean"] > 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


def test_a_traced_run_over_ranks_averages_busy_seconds(capfd):
    rc, lines, detail, err, _ = _run(capfd, 2, traced=True)
    assert rc == 0, err[-3000:]
    (line,) = lines
    dev = line["device"]
    assert len(dev["busy_s_by_rank"]) == 2
    assert dev["busy_s"] == pytest.approx(sum(dev["busy_s_by_rank"]) / 2)
    assert detail[-1]["iterations_by_rank"] == [3, 3]
    assert any(k.startswith("host_ms") for k in line["metrics"])


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[1][0] != "Z"
    except FileNotFoundError:
        return False


def test_a_rank_that_fails_ends_every_worker_and_prints_nothing(
        capfd, monkeypatch):
    pids = []
    spawn = ranks.spawn

    def recorded(*a, **k):
        rc, result, p = spawn(*a, **k)
        pids.extend(p)
        return rc, result, p

    monkeypatch.setattr(ranks, "spawn", recorded)
    rc, lines, _, err, elapsed = _run(capfd, 2, plant="raise", seconds=30)
    assert rc == ranks.FAILED and lines == []
    assert "planted fault" in err and "rank 1 exited" in err
    assert elapsed < 60  # the 30 s window is cut short
    assert len(pids) == 2 and not any(_alive(p) for p in pids)


@pytest.mark.parametrize("world", [2, 4])
def test_a_sharded_configuration_hands_each_rank_its_z_slab(capfd, world):
    rc, lines, _, err, _ = _run(capfd, world, plant="standin",
                                sharding={"axis": "z"}, reference="whole")
    assert rc == 0, err[-3000:]
    (line,) = lines
    assert line["correct"] and line["failed"] == 0, line["checks"]
    records = [json.loads(x)["standin"] for x in err.splitlines()
               if x.startswith('{"standin"')]
    assert len(records) == world
    for rec in records:
        assert rec["shape"] == [24, 24, 24 // world]
        assert rec["global_dims"] == [24, 24, 24]
        assert rec["mesh_dims"] == ["slab"] and rec["mesh_size"] == world


def test_a_z_that_the_ranks_do_not_split_is_refused_at_start(capfd):
    cfg, trf = _tiny_orbit(sharding={"axis": "z"})
    cfg["dims"] = [24, 24, 20]
    args = types.SimpleNamespace(workload="ct256_bone.orbit", seed=SEED,
                                 seconds=0.5, trace=0)
    rc = rmrun.run_spawned(_tiny.bench(), args, 3, "cpu", cfg, trf,
                           ["/nonexistent/worker"])
    assert rc == ranks.FAILED
    assert "does not split" in capfd.readouterr().err


def test_a_one_chip_cell_starts_no_process_and_builds_no_group(
        capfd, monkeypatch):
    calls = []

    def fake_run_cell(cell, seed, seconds, traced, device, t0, **kw):
        calls.append((cell.name, device, kw))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "device": {"platform": "gpu", "kind": "x", "count": 1,
                           "memory_peak_bytes": 1},
                "checks": {}, "setup_detail": {}}

    def refuse(*a, **k):
        raise AssertionError("a one-chip cell started a process or group")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", fake_run_cell)
    monkeypatch.setattr(rmrun, "power_limit", lambda: None)
    monkeypatch.setattr(ranks, "spawn", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    rc = rmrun.main(["--workload", "ct256_bone.orbit", "--seed", "5",
                     "--seconds", "1", "--trace", "0"])
    assert rc == 0
    assert calls == [("ct256_bone.orbit", torch.device("cuda", 0), {})]
    assert not torch.distributed.is_initialized()
    out = capfd.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["correct"]



@pytest.mark.cuda
def test_the_orbit_over_every_card_each_rendering_the_whole_frame(card,
                                                                  capfd):
    """On the cards (skips without one): `ct256_bone`'s orbit at its own
    size through the spawn, one rank a card over NCCL (four where the
    machine has four, else one), each rendering the whole frame, from a
    test-only benchmark dict."""
    world = 4 if torch.cuda.device_count() >= 4 else 1
    bench = _tiny.bench()
    bench["workloads"] = [dict(w, chips=world) if w["name"] ==
                          "ct256_bone.orbit" else w
                          for w in bench["workloads"]]
    args = types.SimpleNamespace(workload="ct256_bone.orbit", seed=SEED,
                                 seconds=5.0, trace=0)
    rc = rmrun.run_spawned(bench, args, world, "cuda")
    out, err = capfd.readouterr()
    assert rc == 0, err[-3000:]
    (line,) = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    print(json.dumps(line))
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["count"] == world
    assert line["device"]["platform"] == "gpu"
    detail = [json.loads(x) for x in err.splitlines()
              if x.startswith('{"setup_s"')][-1]
    assert detail["iterations_by_rank"] == [line["attempted"]] * world
