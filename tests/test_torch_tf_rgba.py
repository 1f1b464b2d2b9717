"""K10, the windowed-TF RGBA unit of the dense shear-warp composite, on the
CPU: the plain forward (`ops/tf_rgba.py::windowed_tf_rgba_plain`) against
the JAX package's `pallas_tf.windowed_tf_rgba` (Pallas in interpret mode),
and the cotangents of `windowed_tf_rgba_vjp` (the plain K10b through its
autograd function) against ``jax.vjp`` of the JAX unit. The CUDA kernels
are held to these plain versions in `test_torch_kernels.py`.

Tolerances: the forward at rtol 1e-6, atol 1e-6 (the JAX package's own
bound for its kernel against XLA); the cotangents at the JAX package's
limits for its unit (`tests/test_pallas_lighting.py`: rtol 1e-4, atol 1e-5,
1e-4 for the window), the sums running in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu.ops import transfer as JT
from tbraymarcherplugin_tpu.ops.pallas_tf import windowed_tf_rgba as jrgba
from tbraymarcherplugin_tpu_torch.ops import tf_rgba as PK10
from tbraymarcherplugin_tpu_torch.ops import transfer as PT

WINDOWS = ([0.45, 0.7, 1.0, 1.0], [0.5, 1.1, 0.0, 0.0])
SHAPE = (5, 9, 13)
# d values, d TF, d window, d step: (rtol, atol)
GRAD_TOL = {"dvalues": (1e-4, 1e-5), "dTF": (1e-4, 1e-5),
            "dwin": (1e-4, 1e-4), "dstep": (1e-4, 1e-5)}


def _step(rng, kind):
    """The step field: the values' full shape, the (n1, n2) field the dense
    composite broadcasts over a block, or one number."""
    if kind == "full":
        return 0.5 + rng.random(SHAPE, dtype=np.float32)
    if kind == "broadcast":
        return 0.5 + rng.random(SHAPE[1:], dtype=np.float32)
    return np.float32(0.9)


def _values(rng, plateaus):
    vals = rng.random(SHAPE, dtype=np.float32) * 1.4 - 0.2
    if plateaus:
        # exactly on the bone TF's alpha plateau at 0 (tf_pos 0.2, texel
        # 50.7 under window (0.45, 0.7)) and at the lower cutoff: the clip's
        # 0.5 subgradient and the cut
        vals.reshape(-1)[::3] = np.float32(0.24)
        vals.reshape(-1)[1::7] = np.float32(0.1)
    return vals


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("step_kind", ["full", "broadcast", "scalar"])
@pytest.mark.parametrize("plateaus", [False, True])
def test_tf_rgba_matches_jax(rng, win, step_kind, plateaus):
    vals = _values(rng, plateaus)
    step = _step(rng, step_kind)
    tf = np.array(JT.tf_ct_bone())
    g = rng.standard_normal(SHAPE + (4,)).astype(np.float32)
    out, vjp = jax.vjp(lambda v, t, w, s: jrgba(v, t, w, s, True),
                       jnp.asarray(vals), jnp.asarray(tf),
                       jnp.asarray(win, jnp.float32), jnp.asarray(step))
    want = dict(zip(GRAD_TOL, vjp(jnp.asarray(g))))

    plain = PK10.windowed_tf_rgba_plain(torch.from_numpy(vals),
                                        torch.from_numpy(tf),
                                        torch.tensor(win),
                                        torch.from_numpy(np.asarray(step)))
    np.testing.assert_allclose(plain.numpy(), np.asarray(out), rtol=1e-6,
                               atol=1e-6)

    leaves = [torch.from_numpy(np.array(x, np.float32)).requires_grad_()
              for x in (vals, tf, win, step)]
    got = PK10.windowed_tf_rgba_vjp(*leaves)
    assert got.shape == SHAPE + (4,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-6, atol=1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    for (name, (rtol, atol)), leaf in zip(GRAD_TOL.items(), leaves):
        ref = np.asarray(want[name])
        assert leaf.grad.shape == ref.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=rtol,
                                   atol=atol, err_msg=name)


def test_tf_rgba_bwd_plain_skips_dstep_when_not_needed(rng):
    vals = torch.from_numpy(_values(rng, False))
    step = torch.from_numpy(_step(rng, "broadcast"))
    tf = JT.tf_ct_bone()
    g = torch.from_numpy(rng.standard_normal(SHAPE + (4,)).astype(np.float32))
    full = PK10.windowed_tf_rgba_bwd_plain(vals, torch.from_numpy(
        np.array(tf)), torch.tensor(WINDOWS[0]), step, g)
    part = PK10.windowed_tf_rgba_bwd_plain(vals, torch.from_numpy(
        np.array(tf)), torch.tensor(WINDOWS[0]), step, g, need_step=False)
    assert part[3] is None and full[3].shape == SHAPE
    for a, b in zip(full[:3], part[:3]):
        assert torch.equal(a, b)


def test_kernel_step_reads_broadcast_fields_unexpanded():
    vals = torch.zeros(SHAPE)
    for step, want in ((torch.ones(SHAPE[1:]), SHAPE[1:]),
                       (torch.ones((1,) + SHAPE[1:]), SHAPE[1:]),
                       (torch.ones(SHAPE), SHAPE),
                       (torch.tensor(0.5), ()),
                       (torch.ones((SHAPE[0], 1, 1)), SHAPE)):
        got = PK10._kernel_step(step, vals)
        assert tuple(got.shape) == want and got.is_contiguous()


def test_xla_unit_tf_lookup_adjoint_is_indexings(rng):
    """The "xla" unit's TF lookup (`transfer.sample_tf`) takes rows by
    `index_select` and sums their cotangents with `bincount`; on the CPU
    that is indexing's own adjoint, bit for bit, with most samples on a few
    texels as in a block of soft tissue."""
    pos = np.where(rng.random(SHAPE) < 0.8, np.float32(0.3),
                   rng.random(SHAPE, dtype=np.float32) * 1.4 - 0.2)
    pos = torch.from_numpy(pos.astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(SHAPE + (4,)).astype(np.float32))
    tf = torch.from_numpy(np.array(JT.tf_ct_bone())).requires_grad_()
    got = PT.sample_tf(tf, pos)
    (got * g).sum().backward()
    d_got, tf.grad = tf.grad, None
    x = pos * 256 - 0.5
    i0 = torch.floor(x)
    c0 = tf[i0.clamp(0, 255).long()]
    c1 = tf[(i0 + 1).clamp(0, 255).long()]
    want = c0 + (c1 - c0) * (x - i0)[..., None]
    (want * g).sum().backward()
    assert torch.equal(got, want)
    assert torch.equal(d_got, tf.grad)

    # under deterministic algorithms the adjoint is indexing's sorted
    # accumulation (`bincount` with weights raises there on the card)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tf.grad = None
        (PT.sample_tf(tf, pos) * g).sum().backward()
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(tf.grad, d_got)
