"""The gather probe (kernel K11), `tools/micro.py`, on the CPU: its plain
version against the JAX package's `jnp.take` (section (f) of
`benchmarks/micro.py`), exactly, at the probe's shapes; and the tool's
refusal to run without a CUDA device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch.tools import micro


def test_gather_probe_plain_matches_jnp_take():
    tab, idx = micro.probe_inputs(seed=3)
    assert tab.shape == (micro.TABLE,) and tab.dtype == torch.float32
    assert idx.shape == micro.SHAPE and idx.dtype == torch.int32
    want = np.asarray(jnp.take(jnp.asarray(tab.numpy()),
                               jnp.asarray(idx.numpy()), axis=0))
    got = micro.gather_probe(tab, idx)  # a CPU tensor: the plain version
    assert got.shape == micro.SHAPE
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_probe_launches_count_only_kernels():
    before = micro.gather_probe.launches
    tab, idx = micro.probe_inputs(seed=1)
    micro.gather_probe(tab[:64], idx[:, :10] % 64)
    assert micro.gather_probe.launches == before


def test_main_exits_2_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a CUDA device")
    assert micro.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
