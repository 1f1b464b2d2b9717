"""K8, the backward of the occluder field's windowed TF alpha, on the CPU:
the plain cotangents (`ops/tf_alpha.py::windowed_tf_alpha_bwd_plain`)
against ``jax.vjp`` of the JAX package's `pallas_tf.windowed_tf_alpha_vjp`
(Pallas in interpret mode), and the counts of how its histogram adds
cluster (``stats=``) against a count in numpy, one element at a time. The
CUDA kernel is held to the plain version in `test_torch_kernels.py`.

Tolerances: the cotangents at the JAX package's own gradient limits (rtol
2e-4, atol 2e-5 of the largest reference value; the sums run in another
order); the counts exactly, their means at rtol 1e-6."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.pallas_tf import windowed_tf_alpha_vjp as jtf
from tbraymarcherplugin_tpu_torch.ops import tf_alpha as PK3

STEP = np.float32(1.3)


def _numpy_stats(vals, g, tf, win):
    """hit share, add rounds per warp of 32 elements (mean, max) and the
    mean run of equal floor texels, one element at a time: an element adds
    when g is not 0, no cutoff drops it and its step correction is not 0
    (1 - alpha at least 1e-10)."""
    f32 = np.float32
    center, width = f32(win[0]), f32(win[1])
    vals, g = vals.reshape(-1), g.reshape(-1)
    tf_pos = (vals - center + width * f32(0.5)) / width
    cut = ((tf_pos < 0) & (win[2] > 0)) | ((tf_pos > 1) & (win[3] > 0))
    x = tf_pos * f32(256.0) - f32(0.5)
    i0f = np.floor(x)
    frac = x - i0f
    i0 = np.clip(i0f, 0, 255).astype(np.int64)
    i1 = np.clip(i0f + 1, 0, 255).astype(np.int64)
    a0, a1 = tf[i0, 3], tf[i1, 3]
    one_m = f32(1.0) - np.clip(a0 + (a1 - a0) * frac, 0, 1)
    hit = (g != 0) & ~cut & (one_m >= f32(1e-10))
    rounds = []
    for w in range(0, len(i0), 32):
        groups = collections.Counter(int(t) for t, h in zip(i0[w:w + 32],
                                                            hit[w:w + 32])
                                     if h)
        rounds.append(max(groups.values(), default=0))
    runs = 1 + sum(int(a != b) for a, b in zip(i0[1:], i0[:-1]))
    return dict(hit=float(hit.mean()), rounds_mean=float(np.mean(rounds)),
                rounds_max=max(rounds), run_mean=len(i0) / runs)


def _field(rng, case):
    """(values, g, window) of one kind: every element on one texel; every
    element clamped below texel 0 (low cutoff off); values past both
    cutoffs in runs of 1-40 equal values; a ragged count (not a multiple of
    32 or of 4) of uniform values."""
    win = [0.45, 0.7, 1.0, 1.0]
    n = 3 * 40 * 37
    if case == "one_texel":
        vals = np.full(n, 0.6, np.float32)
    elif case == "clamped_at_0":
        vals, win = rng.random(n, dtype=np.float32) * 0.05, [0.45, 0.7, 0.0,
                                                             1.0]
    elif case == "cut_runs":
        lengths = rng.integers(1, 41, n)
        vals = np.repeat(rng.random(n, dtype=np.float32) * 1.4 - 0.2,
                         lengths)[:n]
    else:
        n = 1001
        vals = rng.random(n, dtype=np.float32) * 1.4 - 0.2
    g = rng.standard_normal(n).astype(np.float32)
    g[g == 0.0] = np.float32(1.0)
    return vals, g, win


@pytest.mark.parametrize("case", ["one_texel", "clamped_at_0", "cut_runs",
                                  "ragged"])
def test_tf_alpha_bwd_plain_stats_count_hits_rounds_and_runs(rng, case):
    """`windowed_tf_alpha_bwd_plain(stats=)` against the count in numpy;
    the cotangents are the same with and without ``stats``."""
    vals, g, win = _field(rng, case)
    tf = np.array(JT.tf_ct_bone())
    args = (torch.from_numpy(vals), torch.from_numpy(tf), torch.tensor(win),
            float(STEP), torch.from_numpy(g))
    stats = {}
    got = PK3.windowed_tf_alpha_bwd_plain(*args, stats=stats)
    want = PK3.windowed_tf_alpha_bwd_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = _numpy_stats(vals, g, tf, win)
    assert stats["rounds_max"] == ref["rounds_max"]
    for key in ("hit", "rounds_mean", "run_mean"):
        assert stats[key] == pytest.approx(ref[key], rel=1e-6), key
    if case in ("one_texel", "clamped_at_0"):
        assert stats["hit"] == 1.0 and stats["rounds_max"] == 32
        assert stats["run_mean"] == len(vals)
    if case == "cut_runs":
        assert 0.0 < stats["hit"] < 1.0 and stats["run_mean"] > 2.0


@pytest.mark.parametrize("case", ["one_texel", "clamped_at_0", "cut_runs",
                                  "ragged"])
def test_tf_alpha_bwd_plain_matches_jax(rng, case):
    """The plain cotangents (d values, d TF, d window) against ``jax.vjp``
    of the JAX unit on the same fields; d TF holds the alpha column only and
    d window ends in two zeros."""
    vals, g, win = _field(rng, case)
    tf = np.array(JT.tf_ct_bone())
    _, vjp = jax.vjp(lambda v, t, w: jtf(v, t, w, float(STEP),
                                         interpret=True),
                     jnp.asarray(vals), jnp.asarray(tf),
                     jnp.asarray(win, jnp.float32))
    want = vjp(jnp.asarray(g))
    got = PK3.windowed_tf_alpha_bwd_plain(
        torch.from_numpy(vals), torch.from_numpy(tf), torch.tensor(win),
        float(STEP), torch.from_numpy(g), stats={})
    for name, a, b in zip(("dval", "dtf", "dwin"), got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4,
                                   atol=2e-5 * scale, err_msg=name)
    assert not got[1][:, :3].any() and not got[2][2:].any()
