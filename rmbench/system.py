"""The system under test: the PyTorch and CUDA port, driven through its
public entry points. This is the only module of the harness that imports
the port, and it imports it only when a run asks for it.

- :func:`load_kernels` builds (first run in a checkout) and loads the
  port's CUDA kernels into its own ``_build/`` directory.
- :func:`join` joins a run over several cards to the port's process
  group (`parallel.distributed.initialize_multihost`) and makes its mesh
  (`parallel.mesh.make_mesh`, one ``"slab"`` axis over every rank).
- :class:`Viewer` is a viewer's `Renderer` with the configuration's
  volume, TF, window, lights and renderer settings, applying an
  iteration's window, clip plane and lights through the renderer's
  setters. It refuses to run where the renderer stores its volume, light
  volume or planes in another type than the configuration states. For a
  configuration with ``sharding`` it is built from the rank's Z slab with
  the mesh and the whole volume's dims (``mesh=``, ``global_dims=``).
- :class:`FitStep` is the inverse-rendering step: `render_lit_scene`,
  the image loss plus the TF smoothness, ``backward()`` and an Adam step.
"""

from __future__ import annotations

import torch

def load_kernels(device) -> float:
    """Seconds spent compiling the kernels (0 when the build exists);
    nothing to load on the CPU, where the port runs its plain versions."""
    if torch.device(device).type != "cuda":
        return 0.0
    from tbraymarcherplugin_tpu_torch.ops import _kernels

    _, compile_s = _kernels.build()
    _kernels.load()
    return compile_s


def join(world: int, rank: int, address: str, device):
    """Join the process group of ``world`` ranks at ``address`` (an init
    URL) as ``rank``, NCCL on the card and gloo on the CPU; the mesh of
    one ``"slab"`` axis over them."""
    from tbraymarcherplugin_tpu_torch.parallel import distributed, mesh

    distributed.initialize_multihost(address, world, rank,
                                     device=torch.device(device).type)
    return mesh.make_mesh({"slab": world})


def _camera(state):
    from tbraymarcherplugin_tpu_torch.scene import Camera

    return Camera.look_at(state.position, state.target,
                          fov_degrees=state.fov_deg)


class Viewer:
    """A `Renderer` set up as the configuration says (``config["renderer"]``
    with the mix's options already over it). With ``sharding`` in the
    configuration, ``volume`` is the rank's Z slab and ``mesh`` the run's
    mesh; ``render`` then returns the whole frame on rank 0."""

    def __init__(self, config: dict, volume: torch.Tensor,
                 table: torch.Tensor, device, mesh=None):
        from tbraymarcherplugin_tpu_torch.renderer import (Renderer,
                                                           RendererConfig)
        from tbraymarcherplugin_tpu_torch.utils.volume_info import (
            VolumeInfo, WindowingParameters)

        info = None
        if config.get("spacing_mm") is not None:
            info = VolumeInfo(dimensions=tuple(config["dims"]),
                              spacing=tuple(config["spacing_mm"]),
                              is_normalized=True, min_value=0.0,
                              max_value=1.0)
        r = config["renderer"]
        sharded = {}
        if config.get("sharding"):
            sharded = dict(mesh=mesh, global_dims=tuple(config["dims"]))
        self.renderer = Renderer(
            volume, info=info, tf_table=table,
            windowing=WindowingParameters(*config["window"]),
            config=RendererConfig(
                step_count=int(config["step_count"]), jitter=r["jitter"],
                early_termination=r["early_termination"],
                empty_space_skipping=r["empty_space_skipping"],
                light_volume_32bit=r["light_volume_32bit"],
                light_volume_half_resolution=r[
                    "light_volume_half_resolution"]),
            device=device, **sharded)
        self.lights = [(tuple(li["direction"]), float(li["intensity"]))
                       for li in config["lights"]]
        for i, (d, intensity) in enumerate(self.lights):
            self.renderer.add_light(f"light{i}", _light(d, intensity))
        self.width, self.height = int(config["width"]), int(config["height"])
        self.center, self.window_width = (float(x) for x in config["window"])
        self.clip = None
        self.light_updates = 0
        _check_precision(config, self.renderer, device)

    def apply(self, state) -> bool:
        """The setter calls that bring the renderer to ``state``'s window,
        clip plane and lights (none for what is already there); True
        where they make the next render rebuild the illumination."""
        from tbraymarcherplugin_tpu_torch.scene import ClipPlane

        rebuild = False
        if state.window_center != self.center:
            self.renderer.set_window_center(state.window_center)
            self.center, rebuild = state.window_center, True
        if state.window_width != self.window_width:
            self.renderer.set_window_width(state.window_width)
            self.window_width, rebuild = state.window_width, True
        if state.clip != self.clip:
            self.renderer.set_clip_plane(ClipPlane.create(*state.clip))
            self.clip, rebuild = state.clip, True
        for i, light in enumerate(state.lights):
            if light != self.lights[i]:
                self.renderer.update_light(f"light{i}", _light(*light))
                self.lights[i] = light
                self.light_updates += 1
        return rebuild

    def render(self, state) -> torch.Tensor:
        return self.renderer.render(_camera(state), self.width, self.height)


def _check_precision(config: dict, renderer, device) -> None:
    """Raise where the renderer stores the volume, the light volume or, on
    the card, a shear-warp frame's planes in another type than
    ``config["precision"]`` states (on the CPU the port's plain path
    keeps float32 planes)."""
    from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW

    stated = {k: getattr(torch, v) for k, v in config["precision"].items()}
    held = {"volume": renderer.volume.dtype,
            "light_volume": renderer.light_volume.dtype}
    if torch.device(device).type == "cuda":
        held["frame_planes"] = SW.plane_dtype(None, device)
    for key, dtype in held.items():
        if stated[key] != dtype:
            raise ValueError(f"the configuration states {key} "
                             f"{stated[key]}; the renderer holds {dtype}")


class FitStep:
    """One object holding the leaves, the optimizer and the target, whose
    :meth:`step` is one optimizer step of the fit."""

    def __init__(self, config: dict, traffic: dict, volume, table, target,
                 state, device):
        from tbraymarcherplugin_tpu_torch.models import pipeline as PP
        from tbraymarcherplugin_tpu_torch.models.fitting import (
            image_loss, tf_smoothness)
        from tbraymarcherplugin_tpu_torch.ops import shearwarp as SW
        from tbraymarcherplugin_tpu_torch.ops.rays import RayBatch
        from tbraymarcherplugin_tpu_torch.scene import (ClipPlane,
                                                        VolumeTransform)

        self.PP, self.loss_terms = PP, (image_loss, tf_smoothness)
        self.width, self.height = int(config["width"]), int(config["height"])
        dims = tuple(config["dims"])
        transform = VolumeTransform.create()
        self.plan = SW.plan_shearwarp(_camera(state), transform, dims, dims,
                                      self.width, self.height,
                                      max_planes=int(config["step_count"]))
        # the shear-warp branch reads only the screen size off the rays
        screen = torch.empty((self.height, self.width), device=device)
        self.rays = RayBatch(screen, screen, screen)
        self.clip = ClipPlane.disabled()
        self.light_plans = tuple(
            PP.LightPlan.create(transform.local_light_direction(
                _light(li["direction"], li["intensity"])), dims)
            for li in config["lights"])
        self.dims = dims
        self.step_count = int(config["step_count"])
        self.dtype = getattr(torch, config["precision"]["fit_planes"])
        self.tf_unit = traffic["tf_unit"]
        self.smoothness = float(traffic["smoothness"])
        self.target = target
        f32 = torch.float32
        self.params = PP.RenderParams(
            volume=volume,
            tf_table=table.detach().clone().requires_grad_(),
            window_center=torch.tensor(float(traffic["start_center"]),
                                       dtype=f32, device=device)
            .requires_grad_(),
            window_width=torch.tensor(float(config["window"][1]), dtype=f32,
                                      device=device).requires_grad_(),
            light_intensities=torch.tensor(
                [li["intensity"] for li in config["lights"]], dtype=f32,
                device=device))
        self.leaves = (self.params.tf_table, self.params.window_center,
                       self.params.window_width)
        self.opt = torch.optim.Adam(self.leaves, lr=float(traffic["lr"]),
                                    betas=tuple(traffic["betas"]),
                                    eps=float(traffic["eps"]))

    def step(self) -> torch.Tensor:
        """Loss, ``backward()``, the Adam step and the clamps of `fit`;
        returns the loss (a device tensor)."""
        image_loss, tf_smoothness = self.loss_terms
        self.opt.zero_grad(set_to_none=True)
        img = self.PP.render_lit_scene(
            self.params, self.rays, self.clip.center, self.clip.direction,
            self.light_plans, self.dims, step_count=self.step_count,
            march_impl="shearwarp", shearwarp_plan=self.plan,
            shearwarp_dtype=self.dtype, shearwarp_tf_unit=self.tf_unit)
        loss = image_loss(img, self.target)
        if self.smoothness:
            loss = loss + self.smoothness * tf_smoothness(
                self.params.tf_table)
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            self.params.tf_table.clamp_(0.0, 1.0)
            self.params.window_width.clamp_(min=1e-3)
        return loss.detach()


def _light(direction, intensity):
    from tbraymarcherplugin_tpu_torch.scene import DirLight

    return DirLight.create(direction, intensity)
