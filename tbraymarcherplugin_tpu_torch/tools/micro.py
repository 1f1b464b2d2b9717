"""The gather probe (kernel K11): how fast the card gathers single floats
from a table that does not fit one block's shared memory.

    python -m tbraymarcherplugin_tpu_torch.tools.micro

Counterpart of section (f) of `benchmarks/micro.py` (its Pallas kernel
``kern``, a per-lane gather from VMEM); the script's other sections time
JAX programs and are not ported. :func:`gather_probe` launches
`csrc/gather_probe.cu` for CUDA tensors and runs :func:`gather_probe_plain`
for CPU ones. :func:`main` gathers (8, 131072) int32 indices from a
(65536,) float32 table, made from a seed, checks the kernel against the
plain version (exactly) and prints the gather rate of both in G gathers/s,
with the card's name and power limit. Needs a CUDA device; exits with
code 2 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _kernels

TABLE, SHAPE = 65536, (8, 131072)


def gather_probe_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]`` for a 1D table and int32 indices in ``[0, len(tab))``."""
    return tab[idx.long()]


def gather_probe(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]``; see :func:`gather_probe_plain`. The kernel clamps an
    index outside the table to its nearest end."""
    if tab.device.type == "cpu":
        return gather_probe_plain(tab, idx)
    dev = tab.device
    _kernels.check(tab, "tab", torch.float32, dev)
    _kernels.check(idx, "idx", torch.int32, dev)
    if tab.dim() != 1:
        raise ValueError(f"tab must be 1D, got {tuple(tab.shape)}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _kernels.launch("tbr_gather_probe", tab.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), idx.numel(), tab.numel(),
                    _kernels.stream_of(tab))
    gather_probe.launches += 1
    return out


gather_probe.launches = 0


def probe_inputs(device=None, seed: int = 0):
    """The probe's (65536,) float32 table and (8, 131072) int32 indices,
    made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal(TABLE).astype(np.float32)
    idx = rng.integers(0, TABLE, SHAPE, dtype=np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("micro: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    tab, idx = probe_inputs(torch.device("cuda", 0))
    got, want = gather_probe(tab, idx), gather_probe_plain(tab, idx)
    if not torch.equal(got, want):
        print("micro: the gather kernel disagrees with tab[idx]",
              file=sys.stderr)
        return 1
    n = idx.numel()
    ms = event_ms(lambda: gather_probe(tab, idx), 50)
    plain_ms = event_ms(lambda: gather_probe_plain(tab, idx), 50)
    print(f"gather {n / 1e6:.1f}M from {TABLE // 1024}K floats: kernel "
          f"{ms:.4f} ms -> {n / ms / 1e6:.3f} G gathers/s | tab[idx] "
          f"{plain_ms:.4f} ms -> {n / plain_ms / 1e6:.3f} G gathers/s | "
          f"{card}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "ms": ms, "plain_ms": plain_ms,
                      "gathers_per_s": n / ms * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
