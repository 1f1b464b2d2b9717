"""K5 (the backward of the lit composite) through
`shearwarp_intermediate_fused_diff` on the CPU: the port's gradients to
the volume, the TF table, the window and the light volume against the JAX
package's custom-VJP kernel pair (Pallas in interpret mode), on the scene
of `tests/test_shearwarp_grad.py` (24^3, 64x48). The CUDA kernel is held
to the plain version these tests reach in `test_torch_kernels.py`.

Tolerances are the JAX package's own (rtol 2e-4, atol 2e-5 of the largest
reference value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu.ops.shearwarp_grad import (
    shearwarp_intermediate_fused_diff as jdiff,
)
from tbraymarcherplugin_tpu_torch.ops import shearwarp_grad as PG
from test_torch_composite import CLIP, OPAQUE_WIN, WIN, _clip, _scene
from test_torch_grad_units import assert_grad_close

VARIANTS = {
    "cutoffs": ((0.1, -2.3, 0.4), WIN, None),
    "snap": ((0.1, -2.3, 0.4), OPAQUE_WIN, None),  # the 0.95 snap fires
    "clip": ((2.1, 0.7, 0.9), WIN, CLIP),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_diff_grads_match_jax(rng, variant):
    cam_pos, win, clip = VARIANTS[variant]
    vol, lv, tf, jp, pp = _scene(cam_pos)
    c = _clip(clip)
    g = rng.random((4, pp.n1, pp.n2), dtype=np.float32)

    def jfn(v, t, w, light):
        return jdiff(v, t, light, jp, w, jnp.asarray(c.center),
                     jnp.asarray(c.direction), interpret=True,
                     out_layout="chw")

    out, vjp = jax.vjp(jfn, jnp.asarray(vol), jnp.asarray(tf),
                       jnp.asarray(win, jnp.float32), jnp.asarray(lv))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(np.array(x, np.float32)).requires_grad_()
              for x in (vol, tf, win, lv)]
    v, t, w, light = leaves
    got = PG.shearwarp_intermediate_fused_diff(v, t, light, pp, w, c.center,
                                               c.direction)
    # the forward's own bound (test_torch_composite.py): pre-shear matmuls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=2e-5)
    if variant == "snap":
        assert (np.asarray(out)[3] == 1.0).any()
    got.backward(torch.from_numpy(g))
    for name, a, b in zip(("dvol", "dtf", "dwin", "dlight"), leaves, want):
        assert np.abs(np.asarray(b)).max() > 0, name
        assert_grad_close(a.grad, b, name)


def test_composite_bwd_pads_and_types(rng):
    """Planes past K (chunk padding) get exactly zero cotangent, and bf16
    planes get bf16 cotangents rounded from the float32 ones."""
    vol, lv, tf, _, pp = _scene()
    c = _clip(None)
    ops = PG.C.prepare_composite(
        torch.from_numpy(vol), torch.from_numpy(tf), torch.from_numpy(lv),
        pp, torch.tensor(WIN), c.center, c.direction)
    del ops["jitter"], ops["occ"]
    g = torch.from_numpy(rng.random((4, pp.n1, pp.n2), dtype=np.float32))
    ops["g"] = g
    assert ops["W"].shape[0] > ops["k_real"]
    dW, dL, dtf, dwin = PG.composite_bwd(**ops)
    assert float(dW[ops["k_real"]:].abs().max()) == 0.0
    assert float(dL[ops["k_real"]:].abs().max()) == 0.0
    assert float(dW.abs().max()) > 0 and float(dL.abs().max()) > 0
    ops["W"], ops["L"] = ops["W"].bfloat16(), ops["L"].bfloat16()
    bW, bL, _, _ = PG.composite_bwd(**ops)
    assert bW.dtype == torch.bfloat16 and bL.dtype == torch.bfloat16
    want = PG.composite_bwd(**dict(ops, W=ops["W"].float(),
                                   L=ops["L"].float()))
    assert torch.equal(bW, want[0].bfloat16())
    assert torch.equal(bL, want[1].bfloat16())
