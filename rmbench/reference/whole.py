"""The default reference (`frame.py`) for a sharded configuration whose
whole volume fits the check's card: the check hands it a volume source
(`volumes.VolumeSource`) in place of the volume, and this makes the whole
volume from it once, on the TF table's device, then follows `frame.py`.
A configuration names it with ``"reference": "whole"``."""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import frame as F


@functools.lru_cache(maxsize=1)
def _whole(source, device) -> torch.Tensor:
    return source.make(device)


def _scene(scene: F.Scene) -> F.Scene:
    if isinstance(scene.volume, torch.Tensor):
        return scene
    return dataclasses.replace(
        scene, volume=_whole(scene.volume, scene.table.device))


def illumination(scene: F.Scene) -> torch.Tensor:
    return F.illumination(_scene(scene))


def plan(scene: F.Scene, camera):
    return F.plan(_scene(scene), camera)


def frame(scene: F.Scene, camera, light_volume, frame_index: int,
          **kwargs) -> torch.Tensor:
    return F.frame(_scene(scene), camera, light_volume, frame_index,
                   **kwargs)
