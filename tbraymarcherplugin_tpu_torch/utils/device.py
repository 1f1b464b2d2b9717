"""Where an entry point puts its tensors when the caller names no device."""

from __future__ import annotations

import torch


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
