"""State carried across from the JAX package.

The renderer has no learned weights; its state is the scene. The JAX
package's state, handed over as numpy arrays (``np.asarray`` of each JAX
array), becomes the port's records and tensors here, so both packages
compute the same frame from the same numbers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .scene import Camera, ClipPlane, DirLight, VolumeTransform
from .utils.device import resolve_device
from .utils.volume_info import WindowingParameters


def _to_device(x, device) -> torch.Tensor:
    """A float32 copy of array or tensor ``x`` on
    ``resolve_device(device, like=x)``."""
    dev = resolve_device(device, like=x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def to_port_state(arrays: Mapping[str, np.ndarray], device=None) -> dict:
    """Turn the JAX side's state into the port's.

    ``arrays`` keys (numpy arrays, float32 unless noted):

    - ``volume`` (X, Y, Z), ``tf_table`` (R, 4), ``light_volume`` (lx, ly, lz)
    - ``windowing`` (4,): center, width, low cutoff, high cutoff (0 or 1)
    - ``light_directions`` (n, 3) and ``light_intensities`` (n,)
    - ``camera_position`` (3,), ``camera_rotation`` (3, 3),
      ``camera_tan_half_fov`` ()
    - ``clip_center`` (3,), ``clip_direction`` (3,)
    - ``transform_rotation`` (3, 3), ``transform_translation`` (3,),
      ``transform_scale`` (3,)

    Returns a dict: ``volume``, ``tf_table`` and ``light_volume`` tensors on
    ``device`` (None: a tensor keeps its device, anything else goes to the
    card; see `utils.device.resolve_device`); ``windowing``
    (:class:`WindowingParameters`); ``lights`` (list of :class:`DirLight`);
    ``camera``, ``clip_plane``, ``transform``.
    """

    def tensor(name):
        return _to_device(arrays[name], device)

    win = np.asarray(arrays["windowing"], np.float32)
    directions = np.asarray(arrays["light_directions"], np.float32)
    intensities = np.asarray(arrays["light_intensities"], np.float32)
    if directions.shape != (len(intensities), 3):
        raise ValueError("light_directions must be (n, 3) for n intensities")
    return dict(
        volume=tensor("volume"),
        tf_table=tensor("tf_table"),
        light_volume=tensor("light_volume"),
        windowing=WindowingParameters(
            center=float(win[0]), width=float(win[1]),
            low_cutoff=bool(win[2] > 0.0), high_cutoff=bool(win[3] > 0.0),
        ),
        lights=[DirLight(d, i) for d, i in zip(directions, intensities)],
        camera=Camera(arrays["camera_position"], arrays["camera_rotation"],
                      arrays["camera_tan_half_fov"]),
        clip_plane=ClipPlane(arrays["clip_center"], arrays["clip_direction"]),
        transform=VolumeTransform(arrays["transform_rotation"],
                                  arrays["transform_translation"],
                                  arrays["transform_scale"]),
    )


def to_port_render_params(params: Mapping[str, np.ndarray], light_directions,
                          light_dims, device=None,
                          requires_grad: bool = False):
    """Turn the JAX package's ``models.pipeline.RenderParams`` and its
    lights into the port's, so both differentiate the same thing.

    ``params`` maps each field of the JAX ``RenderParams`` (``volume``,
    ``tf_table``, ``window_center``, ``window_width``,
    ``light_intensities``) to a numpy array; ``light_directions`` are the
    local-space directions the JAX ``LightPlan``s were made from. Returns
    (:class:`~.models.pipeline.RenderParams` on ``device``, whose leaves
    take gradients when ``requires_grad``, and the tuple of
    :class:`~.models.pipeline.LightPlan`). With no ``device``, a tensor
    keeps its device and anything else goes to the card.
    """
    from .models.pipeline import LightPlan, RenderParams

    def leaf(name):
        return _to_device(params[name], device).requires_grad_(requires_grad)

    fields = ("volume", "tf_table", "window_center", "window_width",
              "light_intensities")
    plans = tuple(LightPlan.create(d, light_dims) for d in light_directions)
    intensities = params["light_intensities"]
    if len(plans) != (intensities.numel() if isinstance(
            intensities, torch.Tensor) else np.size(intensities)):
        raise ValueError("one light direction per intensity")
    return RenderParams(*(leaf(f) for f in fields)), plans
