"""Where an entry point puts its tensors when the caller names no device,
and the one helper of the frame's host-to-device copies."""

from __future__ import annotations

import torch
from torch.autograd import _profiler_enabled

from .profiling import UPLOAD, span


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` when the caller names one; else that of ``like`` when it
    is a tensor (or a device); else the CUDA card. Without a card that
    raises: the port runs on the CPU only when asked to
    (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if isinstance(like, torch.device):
        return like
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, in a
    ``tbr.upload`` span where that copies host data (an array, a Python
    number or a CPU tensor) to another device. With no profiler recording
    it is ``torch.as_tensor`` after one check of the profiler's state."""
    if _profiler_enabled() and device is not None and (
            torch.device(device).type != "cpu") and not (
            isinstance(x, torch.Tensor) and x.device.type != "cpu"):
        with span(UPLOAD):
            return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)
