"""Checkpoint and resume of optimization state and scene parameters.

Counterpart of `tbraymarcherplugin_tpu/utils/checkpoint.py`: a ``.npz``
checkpoint of a tree of tensors (nested dicts, tuples and lists,
`models.pipeline.RenderParams`, and an optimizer's ``state_dict()``), with
``leaf_{i}`` arrays and a ``metadata_json`` entry, and a manager that keeps
the newest ``ckpt_%08d.npz`` files. The tree's structure, with its
non-tensor values (hyperparameters, flags), is kept as JSON beside the
leaves (``tree_json``), so a tree restores without a template of the same
shape; restored tensors go to the device the caller names, or to that of
the tree they restore into.
The two packages' checkpoints are not meant to be read by each other.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..models.pipeline import RenderParams
from .device import resolve_device

_FIELDS = ("volume", "tf_table", "window_center", "window_width",
           "light_intensities")


def _encode(x: Any, leaves: list) -> Any:
    """JSON-able structure of ``x``; tensors and arrays become leaf
    indices into ``leaves``."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        leaves.append(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x))
        return {"leaf": len(leaves) - 1}
    if isinstance(x, RenderParams):
        return {"params": [_encode(getattr(x, f), leaves) for f in _FIELDS]}
    if isinstance(x, dict):
        return {"dict": [[k, _encode(v, leaves)] for k, v in x.items()]}
    if isinstance(x, (tuple, list)):
        return {type(x).__name__: [_encode(v, leaves) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(node: dict, leaves, device) -> Any:
    (kind, v), = node.items()
    if kind == "leaf":
        return torch.from_numpy(np.array(leaves[v])).to(device)
    if kind == "params":
        return RenderParams(*(_decode(x, leaves, device) for x in v))
    if kind == "dict":
        return {k: _decode(x, leaves, device) for k, x in v}
    if kind in ("tuple", "list"):
        seq = [_decode(x, leaves, device) for x in v]
        return tuple(seq) if kind == "tuple" else seq
    return v


def _device_of(tree: Any):
    """The device of the first tensor in ``tree`` (None if it has none)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, RenderParams):
        tree = [getattr(tree, f) for f in _FIELDS]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for x in tree:
            dev = _device_of(x)
            if dev is not None:
                return dev
    return None


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Save ``tree`` to ``<path>.npz`` (``leaf_{i}``, ``tree_json`` and,
    with ``metadata``, ``metadata_json``)."""
    leaves: list = []
    arrays = {"tree_json": np.frombuffer(
        json.dumps(_encode(tree, leaves)).encode(), dtype=np.uint8)}
    arrays.update({f"leaf_{i}": a for i, a in enumerate(leaves)})
    if metadata:
        arrays["metadata_json"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def restore_pytree(path: str, like: Any,
                   device=None) -> tuple[Any, dict]:
    """Restore a tree saved by :func:`save_pytree` -> (tree, metadata); its
    tensors go to ``device``, or with None to the device of ``like``'s first
    tensor, or, if it has none, to the card (`utils.device.
    resolve_device`)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        structure = json.loads(bytes(z["tree_json"].tobytes()).decode())
        n = sum(1 for name in z.files if name.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        meta = (json.loads(bytes(z["metadata_json"].tobytes()).decode())
                if "metadata_json" in z.files else {})
    device = resolve_device(device, like=_device_of(like))
    return _decode(structure, leaves, device), meta


class CheckpointManager:
    """Rotating checkpoints: ``save(step, tree)`` keeps the newest
    ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def all_steps(self) -> list[int]:
        return sorted(int(name[5:-4]) for name in os.listdir(self.directory)
                      if name.startswith("ckpt_") and name.endswith(".npz"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        meta = dict(metadata or {})
        meta["step"] = step
        save_pytree(self._path(step), tree, meta)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, like: Any, step: int | None = None,
                device=None) -> tuple[Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_pytree(self._path(step), like, device)
