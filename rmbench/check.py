"""The comparison that decides ``correct``: what the timed path produced,
held against the reference, number by number, each against its limit.

Frames: every sampled frame of the window is rendered again by the
reference from the benchmark's own inputs (the illumination rebuilt for
the frame's window and clip plane, then the frame at the same jitter
phase), and the number compared is the frame's relative error,
``|program - reference|_2 / |reference|_2`` over all pixels and channels,
the worst over the sampled frames.

The fit: the first steps of the timed step object are followed by the
reference's own steps from the same start. Compared: each step's loss
(relative gap), each trained leaf's first gradient as Adam holds it after
one step, and each leaf's change after the checked steps (the gap of the
two norms over the larger of the reference leaf's norm and the median
leaf's; leaves whose reference gradient is under a thousandth of the
median leaf's are left out).

The limits live in ``limits/<cell>.json`` with the readings they were set
from (`PERF.md` lists both).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load_limits(cell: str) -> dict:
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-30))


# the share of a frame's values the trimmed error leaves out: rays whose
# early termination (alpha 0.95) falls one step apart on rounding
TRIM = 1e-4


def trimmed_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The mean absolute difference over a frame's values, leaving out the
    largest ``TRIM`` share of them, over the reference's mean absolute
    value."""
    d = (x.float() - ref.float()).abs().flatten()
    k = int(d.numel() * TRIM)
    total = d.sum() - (torch.topk(d, k).values.sum() if k else 0.0)
    return float(total / (d.numel() - k)
                 / ref.float().abs().mean().clamp(min=1e-30))


def err_ratio(x: torch.Tensor, ref: torch.Tensor,
              ref_stated: torch.Tensor) -> float:
    """``x``'s distance from the float32 reference in units of the
    distance the configuration's own plane type puts between the
    reference and itself: about 1 for a program at that precision."""
    return float(torch.linalg.vector_norm((x - ref).float())
                 / torch.linalg.vector_norm((ref_stated - ref).float())
                 .clamp(min=1e-30))


def leaf_gaps(prog: dict, ref: dict, skip=()) -> float:
    """The worst leaf's gap of norms: ``|‖p‖ - ‖r‖|`` over the larger of
    ``‖r‖`` and the median leaf's ``‖r‖``."""
    norms = {k: float(torch.linalg.vector_norm(v.float()))
             for k, v in ref.items()}
    med = statistics.median(norms.values())
    worst = 0.0
    for k, v in prog.items():
        if k in skip:
            continue
        p = float(torch.linalg.vector_norm(v.float()))
        worst = max(worst, abs(p - norms[k]) / max(norms[k], med, 1e-30))
    return worst


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) of the compared numbers; a
    number without a value (nothing to compare) fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out
