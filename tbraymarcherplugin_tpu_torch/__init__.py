"""TBRaymarcherPlugin on PyTorch and CUDA: the shear-warp frame in the lit,
intensity and octree render modes (with a scene-depth ceiling), its
illumination rebuild, the differentiable frame with its backward (fused and
dense shear-warp composites), the ray marches of a camera inside the volume
and the inverse-rendering loop, with hand-written kernels for NVIDIA
Hopper (sm_90a); the volume loaders (MHD, raw, DICOM), the CT presets, the
render CLI and the browser viewer around them; and the same paths across
GPUs on ``torch.distributed`` (``parallel/``).

A port of the JAX package ``tbraymarcherplugin_tpu``, which stays the
reference. This package imports torch and numpy, never jax. The entry
points (``Renderer``, ``convert.to_port_state``,
``convert.to_port_render_params``, ``utils.checkpoint.restore_pytree``,
``tools.render_cli`` and ``tools.viewer`` with ``--device``, the SDF demo
and ``synthetic.mandelbulb_sdf``) put their tensors on the device the caller names; with none, a tensor
argument keeps its device and anything else goes to the CUDA card, and
without a card they raise (``utils/device.py``). Each kernel has a plain
PyTorch version in the same module, taken only for CPU tensors.

Module mapping (port <- JAX package):

=========================  ==============================================
``utils/volume_info.py``   ``utils/volume_info.py`` (formats, windowing,
                           metadata, normalization)
``utils/native.py``        ``utils/native.py`` (builds ``native/tbrnative.cpp``
                           into ``_build/``; numpy without it)
``utils/profiling.py``     ``utils/profiling.py`` (``PhaseTracer``,
                           ``device_trace`` on ``torch.profiler``; here
                           also ``span``, the ``tbr.*`` ranges at the
                           layer boundaries, recorded only while a
                           profiler records)
``utils/device.py``        (the entry points' default device;
                           ``to_device``, the host-to-device copies of a
                           frame, in ``tbr.upload`` spans)
``io/``                    ``io/`` (loaders, ``minidicom``, assets)
``scene.py``               ``scene.py``
``ops/compositing.py``     ``ops/compositing.py``
``ops/transfer.py``        ``ops/transfer.py`` (+ ``tf_presets_data.py``)
``ops/sampling.py``        ``ops/sampling.py``
``ops/rays.py``            ``ops/rays.py``
``ops/synthetic.py``       ``ops/synthetic.py``
``ops/sdf_march.py``       ``ops/sdf_march.py`` (plain torch)
``ops/shearwarp.py``       ``ops/shearwarp.py`` (plan, pre-shear with
                           nearest, dense composite, warp,
                           ``depth_to_lambda_max``)
``ops/lighting.py``        ``ops/lighting.py``
``ops/tf_alpha.py``        ``ops/pallas_tf.py`` (K3, ``csrc/tf_alpha.cu``;
                           K8, ``csrc/tf_alpha_bwd.cu``)
``ops/tf_rgba.py``         ``ops/pallas_tf.py`` (K10a, ``csrc/tf_rgba.cu``;
                           K10b, ``csrc/tf_rgba_bwd.cu``)
``ops/light_scan.py``      ``ops/pallas_lighting.py`` (K4,
                           ``csrc/light_scan.cu``; K7,
                           ``csrc/light_scan_bwd.cu``)
``ops/composite.py``       ``ops/shearwarp_pallas.py`` (K1,
                           ``csrc/composite.cu``: lit, unlit,
                           intensity; jitter, ``depth_lam``)
``ops/shearwarp_grad.py``  ``ops/shearwarp_grad.py`` (K5,
                           ``csrc/composite_bwd.cu``)
``ops/warp.py``            ``ops/pallas_warp.py`` (K2, ``csrc/row_lerp.cu``;
                           K6, ``csrc/row_lerp_bwd.cu``)
``ops/march.py``           ``ops/march.py``
``ops/fused_march.py``     ``ops/pallas_march.py`` (K9, ``csrc/march.cu``)
``ops/octree.py``          ``ops/octree.py`` (pyramids, ``march_octree``,
                           occupancy grid)
``models/pipeline.py``     ``models/pipeline.py`` (shear-warp and march
                           branches)
``models/fitting.py``      ``models/fitting.py``
``utils/checkpoint.py``    ``utils/checkpoint.py``
``tools/micro.py``         ``benchmarks/micro.py`` section (f) (K11,
                           ``csrc/gather_probe.cu``)
``tools/profile_frame.py`` (per-op device time on one GPU)
``tools/parallel_check.py`` (the ``parallel/`` paths across GPUs against
                           one device)
``tools/render_cli.py``    ``tools/render_cli.py`` (PNGs by ``tools/png.py``)
``tools/viewer.py``        ``tools/viewer.py``
``convert.py``             (JAX state as numpy -> the port's state)
``renderer.py``            ``renderer.py`` (the three modes, scene depth,
                           march fallback)
``parallel/``              ``parallel/`` on ``torch.distributed``:
                           ``distributed`` (process group: NCCL on the
                           card, gloo on the CPU), ``mesh``
                           (``DeviceMesh``, DTensor placements),
                           ``overlap`` (all-reduce inside the backward,
                           autograd all-gather), ``ray_sharding`` (ray-tile
                           DP, train step), ``shearwarp_sharding`` (column
                           slabs: K1/K5 per slab, K2/K6 on the gathered
                           image), ``slab_sharding`` (Z slabs: segment
                           march, ray-state ring, illumination v1, v2)
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
