"""The tile intervals of the composite kernels K1 and K5
(`ops/composite.py::tile_plane_bounds`) against the JAX package's per-tile
chunk bounds, and against the plain composite's own in-cube test; and
K5's plain histogram clustering counts (`composite_bwd_plain(stats=)`).
All on the CPU: the kernels themselves are held to their plain versions in
`test_torch_kernels.py`."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tbraymarcherplugin_tpu import scene as JS
from tbraymarcherplugin_tpu.ops import shearwarp as JSW
from tbraymarcherplugin_tpu.ops.shearwarp_pallas import (
    _bounds_from_validity,
    _geo_chunk_validity,
)
from tbraymarcherplugin_tpu_torch import scene as PS
from tbraymarcherplugin_tpu_torch.ops import composite as PC
from tbraymarcherplugin_tpu_torch.ops import shearwarp as PSW
from tbraymarcherplugin_tpu_torch.ops import shearwarp_grad as PK5

CAMS = ((0.1, -2.3, 0.4), (2.1, 0.7, 0.9), (-1.4, 1.2, -1.5),
        (0.3, 0.2, 2.4), (-2.0, -1.1, 0.2))
DIMS = (40, 32, 36)


def _jax_plan(pos, dims, w, h, max_planes):
    return JSW.plan_shearwarp(
        JS.Camera.look_at(list(pos), [0.0, 0.0, 0.0], fov_degrees=40.0),
        JS.VolumeTransform.create(), dims, dims, w, h,
        max_planes=max_planes)


def _chunks(bounds):
    """Plane intervals [lo, hi) -> chunk intervals, (0, 0) where empty."""
    lo, hi = bounds[..., 0], bounds[..., 1]
    empty = lo >= hi
    return (np.where(empty, 0, lo // PC.KB),
            np.where(empty, 0, -(-hi // PC.KB)))


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("pos", CAMS)
def test_tile_bounds_match_jax_chunk_bounds(pos, ragged, jitter):
    """At the JAX kernel's (8, 128) tiles, the port's plane intervals give
    the JAX package's chunk intervals (`_geo_chunk_validity` +
    `_bounds_from_validity`), on full plans and on plans cut to ragged
    n1, n2 (the JAX function takes the full tiles only). With jitter the
    JAX package keeps plane k where both axes are in at k or both at k + 1;
    the port takes each axis's hull over k and k + 1. They differ only at a
    corner of the footprint, where one axis comes in as the other goes
    out: there the JAX interval is empty and the port's is that one plane,
    where some tiles do sample inside the cube at some jitter."""
    jp = _jax_plan(pos, DIMS, 960, 540, 45)
    if ragged:
        jp = dataclasses.replace(jp, n1=jp.n1 - 5, n2=jp.n2 - 77)
    K, n1, n2 = jp.k, jp.n1, jp.n2
    Kp = -(-K // PC.KB) * PC.KB
    d1, d2 = DIMS[jp.axes12[0]], DIMS[jp.axes12[1]]
    t1, t2 = n1 // 8, n2 // 128
    assert t1 >= 2 and t2 >= 2
    want = np.asarray(_bounds_from_validity(_geo_chunk_validity(
        jp, d1, d2, Kp, PC.KB, jitter=jitter))).reshape(t1, t2, 2)
    # the JAX function's plane k + 1 of the last plane is the last plane
    # itself (or a padding plane that no sample passes): no extrapolation
    pa = np.stack([np.asarray(x, np.float32) for x in
                   (jp.a1, jp.b1, jp.a2, jp.b2, jp.lam)])
    pa = np.concatenate([pa, pa[:, -1:]], axis=1)
    got = PC.tile_plane_bounds(pa, n1, n2, d1, d2, K, tile=(8, 128),
                               jitter=jitter)
    assert got.shape == (-(-n1 // 8), -(-n2 // 128), 2)
    lo, hi = _chunks(got[:t1, :t2])
    differ = (lo != want[..., 0]) | (hi != want[..., 1])
    assert differ.sum() <= (8 if jitter else 0)
    real = []
    for r, c in np.argwhere(differ):
        k, k_hi = got[r, c]
        assert want[r, c].tolist() == [0, 0] and k_hi == k + 1
        gi = torch.arange(8 * r, 8 * r + 8, dtype=torch.float32)[:, None]
        gj = torch.arange(128 * c, 128 * c + 128, dtype=torch.float32)[None]
        real.append(any(bool(PC.in_cube_plain(
            pa, int(k), gi, gj, torch.full((8, 128), float(t)), d1, d2
        )[0].any()) for t in np.linspace(0.0, 1.0, 257)[:-1]))
    assert not real or any(real)  # the JAX union drops real samples
    # the cube's footprint cuts some tiles' intervals short
    spans = hi - lo
    assert (spans > 0).any() and (spans < Kp // PC.KB).any()


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(az=st.floats(0.0, 2 * np.pi), el=st.floats(-1.2, 1.2),
       dist=st.floats(1.7, 3.5), fov=st.floats(20.0, 70.0),
       dims=st.tuples(*[st.integers(6, 20)] * 3),
       size=st.tuples(st.integers(24, 90), st.integers(16, 70)),
       planes=st.integers(5, 40), align=st.sampled_from([1, 3, 8]),
       jitter=st.booleans(), seed=st.integers(0, 2**31 - 1))
def test_tile_bounds_hold_every_in_cube_sample(az, el, dist, fov, dims, size,
                                               planes, align, jitter, seed):
    """At the kernels' own tile (32 pixels of one row), every
    (pixel, plane) whose sample the plain composite finds inside the cube
    (`composite.in_cube_plain`, jitter or not) lies in its tile's
    interval; random cameras and volumes, ragged n1 and n2."""
    pos = (dist * np.cos(el) * np.cos(az), dist * np.cos(el) * np.sin(az),
           dist * np.sin(el))
    plan = PSW.plan_shearwarp(
        PS.Camera.look_at(pos, (0.0, 0.0, 0.0), fov_degrees=fov),
        PS.VolumeTransform.create(), dims, dims, *size, align=align,
        max_planes=planes)
    if plan is None:  # the camera sits in the dominant slab
        return
    K, n1, n2 = plan.k, plan.n1, plan.n2
    d1, d2 = dims[plan.axes12[0]], dims[plan.axes12[1]]
    pa = PC._plane_param_array(plan, -(-K // PC.KB) * PC.KB, extend=jitter)
    bounds = PC.tile_plane_bounds(pa, n1, n2, d1, d2, K, jitter=jitter)
    th, tw = PC.TILE
    assert bounds.shape == (-(-n1 // th), -(-n2 // tw), 2)
    rng = np.random.default_rng(seed)
    jit = (torch.from_numpy(rng.random((n1, n2), dtype=np.float32))
           if jitter else None)
    gi = torch.arange(n1, dtype=torch.float32)[:, None]
    gj = torch.arange(n2, dtype=torch.float32)[None, :]
    ti = np.arange(n1)[:, None] // th
    tj = np.arange(n2)[None, :] // tw
    lo, hi = bounds[ti, tj, 0], bounds[ti, tj, 1]
    for k in range(K):
        cube, _ = PC.in_cube_plain(pa, k, gi, gj, jit, d1, d2)
        cube = np.broadcast_to(cube.numpy(), (n1, n2))
        assert ((lo <= k) & (k < hi))[cube].all(), k


def _numpy_clustering(texel, hit):
    """`shearwarp_grad._add_clustering`'s sums, plane by plane, counted
    with loops over (K, n) flat texels and hits."""
    out = dict(pixels=0, hits=0, warps=0, warps_hit=0, rounds=0, runs=0,
               rounds_max=0)
    for t, h in zip(texel, hit):
        n = len(t)
        out["pixels"] += n
        out["hits"] += int(h.sum())
        for w in range(0, n, 32):
            tw = t[w:w + 32][h[w:w + 32]]
            out["warps"] += 1
            r = max(np.unique(tw, return_counts=True)[1], default=0)
            out["warps_hit"] += int(r > 0)
            out["rounds"] += int(r)
            out["rounds_max"] = max(out["rounds_max"], int(r))
        for x in range(n):
            if h[x] and not (x > 0 and h[x - 1] and t[x - 1] == t[x]):
                out["runs"] += 1
    return out


def test_composite_bwd_plain_stats_count_hits_rounds_and_runs():
    """`composite_bwd_plain(stats=)` against a count in numpy, on a hand-made
    input: three planes of (2, 40) pixels whose values sit on chosen
    texels, the columns past 35 outside the cube, alpha too small to
    terminate, no cutoffs (so a pixel adds exactly where it is inside);
    the cotangents are the same with and without ``stats``."""
    rng = np.random.default_rng(7)
    K, n1, n2 = 3, 2, 40
    texel = np.repeat(rng.integers(0, 6, (K, n1 * n2 // 2)), 2, axis=1)
    texel[:, 7::9] = 200  # runs broken
    W = ((texel + 1.0) / 256.0).astype(np.float32).reshape(K, n1, n2)
    pa = np.array([[0.0] * K, [0.0] * K, [0.0] * K, [0.1] * K,
                   [1.0, 2.0, 3.0]], np.float32)
    tf = np.tile(np.array([0.3, 0.6, 0.9, 0.5], np.float32), (256, 1))
    tf[:, 0] = np.linspace(0.0, 1.0, 256)
    ops = dict(W=torch.from_numpy(W),
               L=torch.from_numpy(rng.random((K, n1, n2), dtype=np.float32)),
               tf_table=torch.from_numpy(tf), pa=pa,
               e1=torch.ones((n1, n2)),
               step_world=torch.full((n1, n2), 0.01),
               win=torch.tensor([0.5, 1.0, 0.0, 0.0]),
               g=torch.from_numpy(rng.standard_normal((4, n1, n2)).astype(
                   np.float32) + 3.0),
               e0=1.0, early_termination=0.95, d1=4, d2=4, k_real=K)
    stats = {}
    got = PK5.composite_bwd_plain(**ops, stats=stats)
    want = PK5.composite_bwd_plain(**ops)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = np.broadcast_to(np.arange(n2) <= 35, (K, n1, n2)).reshape(K, -1)
    assert stats == _numpy_clustering(texel, hit)
    summary = PK5.clustering_summary(stats)
    assert summary["hit"] == pytest.approx(72 / 80)
    assert 1.0 < summary["run_mean"] < 2.0 and stats["rounds_max"] >= 2
