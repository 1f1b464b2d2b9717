"""TBRaymarcherPlugin on PyTorch and CUDA: the lit shear-warp frame, its
illumination rebuild, the differentiable frame with its backward (fused and
dense shear-warp composites), the ray march of a camera inside the volume
and the inverse-rendering loop, with hand-written kernels for NVIDIA
Hopper (sm_90a).

A port of the JAX package ``tbraymarcherplugin_tpu``, which stays the
reference. This package imports torch and numpy, never jax. Tensors live
on the device the caller names; each kernel has a plain PyTorch version in
the same module, taken only for CPU tensors.

Module mapping (port <- JAX package):

=========================  ==============================================
``utils/volume_info.py``   ``utils/volume_info.py`` (windowing, metadata)
``scene.py``               ``scene.py``
``ops/compositing.py``     ``ops/compositing.py``
``ops/transfer.py``        ``ops/transfer.py`` (no presets yet)
``ops/sampling.py``        ``ops/sampling.py``
``ops/rays.py``            ``ops/rays.py``
``ops/synthetic.py``       ``ops/synthetic.py`` (``ct_like_phantom``,
                           ``sphere_volume``)
``ops/shearwarp.py``       ``ops/shearwarp.py`` (plan, pre-shear, dense
                           composite, warp)
``ops/lighting.py``        ``ops/lighting.py``
``ops/tf_alpha.py``        ``ops/pallas_tf.py`` (K3, ``csrc/tf_alpha.cu``;
                           K8, ``csrc/tf_alpha_bwd.cu``)
``ops/tf_rgba.py``         ``ops/pallas_tf.py`` (K10a, ``csrc/tf_rgba.cu``;
                           K10b, ``csrc/tf_rgba_bwd.cu``)
``ops/light_scan.py``      ``ops/pallas_lighting.py`` (K4,
                           ``csrc/light_scan.cu``; K7,
                           ``csrc/light_scan_bwd.cu``)
``ops/composite.py``       ``ops/shearwarp_pallas.py`` (K1,
                           ``csrc/composite.cu``)
``ops/shearwarp_grad.py``  ``ops/shearwarp_grad.py`` (K5,
                           ``csrc/composite_bwd.cu``)
``ops/warp.py``            ``ops/pallas_warp.py`` (K2, ``csrc/row_lerp.cu``;
                           K6, ``csrc/row_lerp_bwd.cu``)
``ops/march.py``           ``ops/march.py``
``ops/fused_march.py``     ``ops/pallas_march.py`` (K9, ``csrc/march.cu``)
``ops/octree.py``          ``ops/octree.py`` (pyramids, occupancy grid)
``models/pipeline.py``     ``models/pipeline.py`` (shear-warp and march
                           branches)
``models/fitting.py``      ``models/fitting.py``
``utils/checkpoint.py``    ``utils/checkpoint.py``
``tools/micro.py``         ``benchmarks/micro.py`` section (f) (K11,
                           ``csrc/gather_probe.cu``)
``tools/profile_frame.py`` (per-op device time on one GPU)
``convert.py``             (JAX state as numpy -> the port's state)
``renderer.py``            ``renderer.py`` (lit mode, march fallback)
=========================  ==============================================
"""

from .scene import Camera, ClipPlane, DirLight, VolumeTransform, orbit_camera
from .utils.volume_info import VolumeInfo, WindowingParameters

__all__ = [
    "Camera",
    "ClipPlane",
    "DirLight",
    "VolumeInfo",
    "VolumeTransform",
    "WindowingParameters",
    "orbit_camera",
]
