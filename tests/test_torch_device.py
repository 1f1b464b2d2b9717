"""With no device named, the port's entry points keep a tensor argument on
its device and put anything else on the CUDA card; without a card they
raise and never carry on on the CPU. Here, without a card, each must raise,
and run on the CPU when asked to."""

import numpy as np
import pytest
import torch

from tbraymarcherplugin_tpu_torch import convert
from tbraymarcherplugin_tpu_torch.ops import synthetic
from tbraymarcherplugin_tpu_torch.renderer import Renderer
from tbraymarcherplugin_tpu_torch.utils import checkpoint as CK

FIELDS = ("volume", "tf_table", "window_center", "window_width",
          "light_intensities")


def _arrays():
    """The JAX side's state as numpy arrays (`convert.to_port_state`)."""
    return dict(
        volume=synthetic.ct_like_phantom((8, 8, 8)),
        tf_table=np.ones((256, 4), np.float32),
        light_volume=np.ones((8, 8, 8), np.float32),
        windowing=np.array([0.5, 0.8, 1.0, 1.0], np.float32),
        light_directions=np.array([[0.3, 0.1, -0.95]], np.float32),
        light_intensities=np.array([1.0], np.float32),
        camera_position=np.array([0.1, -2.3, 0.4], np.float32),
        camera_rotation=np.eye(3, dtype=np.float32),
        camera_tan_half_fov=np.float32(0.4),
        clip_center=np.zeros(3, np.float32),
        clip_direction=np.array([0.0, 0.0, 1.0], np.float32),
        transform_rotation=np.eye(3, dtype=np.float32),
        transform_translation=np.zeros(3, np.float32),
        transform_scale=np.ones(3, np.float32))


def _entry(name, tmp_path):
    """``call(device, tensors)`` of entry point ``name`` -> a tensor it
    made; ``tensors``: its inputs are CPU tensors (else numpy arrays)."""
    arrays = _arrays()

    def inputs(tensors, d):
        return {k: torch.from_numpy(np.asarray(v)) if tensors else v
                for k, v in d.items()}

    if name == "renderer":
        return lambda dev, tensors: Renderer(
            inputs(tensors, arrays)["volume"], device=dev).volume
    if name == "to_port_state":
        return lambda dev, tensors: convert.to_port_state(
            inputs(tensors, arrays), device=dev)["volume"]
    if name == "to_port_render_params":
        params = {f: arrays.get(f, np.float32(0.5)) for f in FIELDS}
        return lambda dev, tensors: convert.to_port_render_params(
            inputs(tensors, params), arrays["light_directions"], (8, 8, 8),
            device=dev)[0].volume
    path = str(tmp_path / "tree")
    CK.save_pytree(path, {"volume": torch.from_numpy(arrays["volume"])})
    return lambda dev, tensors: CK.restore_pytree(
        path, torch.zeros(2) if tensors else None, device=dev)[0]["volume"]


@pytest.mark.parametrize("name", ["renderer", "to_port_state",
                                  "to_port_render_params", "restore_pytree"])
def test_entry_points_default_to_the_card(name, tmp_path):
    call = _entry(name, tmp_path)
    if torch.cuda.is_available():
        assert call(None, False).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None, False)
    assert call("cpu", False).device.type == "cpu"
    # tensor arguments keep their device (restore_pytree: ``like``'s)
    assert call(None, True).device.type == "cpu"
