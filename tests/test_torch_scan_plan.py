"""K4's launch plan (`ops/light_scan.py::scan_plan`) on the CPU.

The kernel (`csrc/light_scan.cu`) cuts a face into row bands, one a block,
and runs the slices in groups of T: a block loads its band plus a halo of
T * reach rows of the slice before the group, computes the group's slices
on that sub-face and keeps its own rows. This test runs that schedule with
the plain shift (`shift_2d_bilinear_border`, whose border is wrong at a
sub-face's inner edge) and holds every band's own rows of every slice to
`propagate_face_scan_plain` bit for bit, for random shapes, offsets, SM
counts and shared-memory sizes; and it shows that a halo one row short is
caught.
"""

import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch.ops import light_scan as PK4
from tbraymarcherplugin_tpu_torch.tools.sweep_scans import K4_VARIANTS

H100 = (132, 232448)  # SMs, shared memory a block may opt in to (bytes)


def emulate(op, off_px, off_py, alpha, plan, halo_short=0):
    """K4's banded, T-slice schedule of ``plan`` on the CPU."""
    K, H, W = op.shape
    out = torch.empty_like(op)
    halo = plan.halo - halo_short
    for g in range(plan.groups(K)):
        k0 = g * plan.slices
        prev = out[k0 - 1] if k0 else torch.full((H, W), alpha)
        for b in range(plan.blocks):
            r0, r1 = b * plan.rows, min(b * plan.rows + plan.rows, H)
            lo, hi = (r0 - halo, r1) if plan.up else (r0, r1 + halo)
            f0, f1 = max(lo, 0), min(hi, H)
            sub = prev[f0:f1]
            for k in range(k0, min(k0 + plan.slices, K)):
                sub = PK4.shift_2d_bilinear_border(
                    sub, off_px, off_py, alpha) * (1.0 - op[k, f0:f1])
                out[k, r0:r1] = sub[r0 - f0:r1 - f0]
    return out


def check_plan(plan, k, h, w, off_px, sms, smem, vec=None):
    """The plan's shape holds what the kernel assumes of it."""
    assert 1 <= plan.blocks <= sms
    assert plan.blocks * plan.rows >= h > (plan.blocks - 1) * plan.rows
    ix = int(np.floor(np.float32(off_px)))
    assert plan.up == (ix < 0)
    assert plan.reach == (-ix if ix < 0 else ix + 1) >= 1
    assert plan.slices >= 1 and (plan.staged or plan.slices == 1)
    assert plan.smem <= smem
    assert plan.vec == (vec or (4 if w % 4 == 0 else 1))
    units = (plan.rows + (plan.slices - 1) * plan.reach) * w // plan.vec
    assert plan.threads * plan.per_thread * plan.chunks >= units
    assert plan.per_thread in ((1, 2, 3, 4) if plan.vec == 1 else (1, 2))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.groups(k) == -(-k // plan.slices)


def _face(rng, k, h, w):
    return torch.from_numpy(rng.random((k, h, w), dtype=np.float32) * 0.4)


@pytest.mark.parametrize("seed", range(16))
def test_banded_schedule_is_exact(seed):
    """Random faces, offsets up to 12.5 px of both signs, 1-40 SMs and
    shared memory from a few rows to the H100's: the planned schedule
    gives the plain version's bits."""
    rng = np.random.default_rng(seed)
    k, h, w = (int(rng.integers(1, 21)), int(rng.integers(1, 80)),
               int(rng.integers(1, 40)))
    off = (np.float32(rng.uniform(-12.5, 12.5)),
           np.float32(rng.uniform(-6.0, 6.0)))
    sms = int(rng.integers(1, 41))
    smem = int(rng.choice([w * 4 * 3, w * 4 * 12, 48 * 1024, H100[1]]))
    alpha = float(np.float32(rng.uniform(0.3, 1.0)))
    op = _face(rng, k, h, w)
    plan = PK4.scan_plan(k, h, w, off[0], sms, smem)
    check_plan(plan, k, h, w, off[0], sms, smem)
    want = PK4.propagate_face_scan_plain(op, *off, alpha)
    assert torch.equal(emulate(op, *off, alpha, plan), want)


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("off", [(-0.33, 3.17), (0.37, -1.6), (-10.4, 3.3),
                                 (7.6, -12.2)])
def test_every_group_size_is_exact(off, slices):
    """T forced to 1-8 on a face cut into bands of 3 rows, the bench
    face's offsets and row shifts past several bands."""
    rng = np.random.default_rng(slices)
    k, h, w = 11, 45, 24
    op = _face(rng, k, h, w)
    plan = PK4.scan_plan(k, h, w, off[0], 15, H100[1], slices=slices)
    assert plan.slices == slices and plan.rows == 3
    check_plan(plan, k, h, w, off[0], 15, H100[1])
    want = PK4.propagate_face_scan_plain(op, *off, 0.8)
    assert torch.equal(emulate(op, *off, 0.8, plan), want)


@pytest.mark.parametrize("k,h,w,off,smem,slices,staged", [
    # the bench face, cut to depth
    (12, 256, 256, (-0.33, 3.17), H100[1], 8, True),
    # 2048 rows: 16 a block
    (3, 2048, 64, (-10.4, 3.3), H100[1], 1, True),
    # a band and its halo beyond shared memory: unstaged, taps from L2
    (2, 4096, 64, (10.4, -3.3), 8192, 1, False),
])
def test_large_faces_are_exact(k, h, w, off, smem, slices, staged):
    rng = np.random.default_rng(h)
    op = _face(rng, k, h, w)
    plan = PK4.scan_plan(k, h, w, off[0], H100[0], smem)
    assert (plan.slices, plan.staged) == (slices, staged)
    check_plan(plan, k, h, w, off[0], H100[0], smem)
    want = PK4.propagate_face_scan_plain(op, *off, 0.7)
    assert torch.equal(emulate(op, *off, 0.7, plan), want)


@pytest.mark.parametrize("off,slices", [((-0.33, 0.4), 8), ((0.37, -0.6), 4),
                                        ((-2.4, 1.3), 2), ((3.7, -0.6), 1)])
def test_a_halo_one_row_short_is_caught(off, slices):
    """The emulation has teeth: a band that loads one row less than the
    plan's halo gets other bits (column shifts small enough that the
    column border does not swamp the rows)."""
    rng = np.random.default_rng(3)
    k, h, w = 2 * slices, 40, 32
    op = _face(rng, k, h, w)
    plan = PK4.scan_plan(k, h, w, off[0], 10, H100[1], slices=slices)
    want = PK4.propagate_face_scan_plain(op, *off, 0.9)
    assert torch.equal(emulate(op, *off, 0.9, plan), want)
    assert not torch.equal(emulate(op, *off, 0.9, plan, halo_short=1), want)


def test_plan_picks_groups_by_reach_and_shared_memory():
    """T is the largest power of two up to 8 whose halo stays within 8
    rows and whose two stage buffers fit; a face too large to stage runs
    unstaged."""
    sms, smem = H100
    assert PK4.scan_plan(256, 256, 256, -0.33, sms, smem).slices == 8
    assert PK4.scan_plan(256, 256, 256, 2.5, sms, smem).slices == 2
    assert PK4.scan_plan(256, 256, 256, -10.4, sms, smem).slices == 1
    assert PK4.scan_plan(3, 256, 256, 0.2, sms, smem).slices == 2
    big = PK4.scan_plan(8, 1024, 1024, -0.5, sms, smem)
    assert big.slices == 8 and big.staged and big.smem <= smem
    assert not PK4.scan_plan(1, 4096, 4096, 0.3, sms, smem).staged
    with pytest.raises(ValueError):
        PK4.scan_plan(4, 64, 64, 0.3, sms, smem, slices=2, staged=False)


@pytest.mark.parametrize("off", [(-0.33, 3.17), (2.7, -0.4)])
@pytest.mark.parametrize("name,forced", K4_VARIANTS,
                         ids=[n for n, _ in K4_VARIANTS])
def test_forced_plans_are_exact(name, forced, off):
    """Every plan `tools/sweep_scans.py` forces on the card (T 1-16, staged
    or not, units of 4 or 1 pixels), T = 16 beyond the planner's halo cap
    included, on a face cut into bands of 5 rows."""
    rng = np.random.default_rng(len(name))
    k, h, w = 19, 64, 64
    op = _face(rng, k, h, w)
    plan = PK4.scan_plan(k, h, w, off[0], 15, H100[1], **forced)
    assert plan.slices == forced["slices"] and plan.rows == 5
    assert plan.staged == forced.get("staged", True)
    check_plan(plan, k, h, w, off[0], 15, H100[1], forced.get("vec"))
    want = PK4.propagate_face_scan_plain(op, *off, 0.85)
    assert torch.equal(emulate(op, *off, 0.85, plan), want)


@pytest.mark.parametrize("w,smem,forced", [
    (64, H100[1], dict(slices=2, staged=False)),  # unstaged hands off a slice
    (64, 1024, dict(slices=1, staged=True)),      # the stage exceeds smem
    (30, H100[1], dict(vec=4)),                   # units of 4 in 30 columns
    (64, H100[1], dict(vec=2)),
])
def test_forced_plans_that_cannot_run_raise(w, smem, forced):
    with pytest.raises(ValueError):
        PK4.scan_plan(4, 64, w, 0.3, 8, smem, **forced)
