"""Scene records: directional lights, clipping planes, volume transform, camera.

Counterpart of `tbraymarcherplugin_tpu/scene.py`. The records are small and
host-side: every field is a float32 numpy array, so the values (and the
host-side plans built from them) are the same float32 numbers the JAX
package holds. Rotations are 3x3 matrices whose rows multiply on the right;
world = (local * scale) @ rotation + translation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .utils.profiling import CAMERA, span


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class DirLight:
    """Directional light: world direction it shines towards + intensity
    (`FDirLightParameters`, `RaymarchTypes.h:19-41`)."""

    direction: np.ndarray
    intensity: np.ndarray | float = 1.0

    def __post_init__(self):
        self.direction = _f32(self.direction)
        self.intensity = _f32(self.intensity)

    @staticmethod
    def create(direction, intensity=1.0) -> "DirLight":
        return DirLight(direction, intensity)


@dataclasses.dataclass
class ClipPlane:
    """Clip plane: center + direction; points with
    ``dot(P - center, dir) <= 0`` are clipped (`RaymarcherCommon.usf:22-25`)."""

    center: np.ndarray
    direction: np.ndarray

    def __post_init__(self):
        self.center = _f32(self.center)
        self.direction = _f32(self.direction)

    @staticmethod
    def create(center, direction) -> "ClipPlane":
        return ClipPlane(center, direction)

    @staticmethod
    def disabled() -> "ClipPlane":
        """A plane that clips nothing (center far below, facing up)."""
        return ClipPlane([0.0, 0.0, -1e6], [0.0, 0.0, 1.0])


@dataclasses.dataclass
class VolumeTransform:
    """Rotation, translation and per-axis scale placing the centered unit
    cube [-0.5, 0.5]^3 in world space; UVW space is [0, 1]^3."""

    rotation: np.ndarray
    translation: np.ndarray
    scale: np.ndarray

    def __post_init__(self):
        self.rotation = _f32(self.rotation)
        self.translation = _f32(self.translation)
        self.scale = _f32(self.scale)

    @staticmethod
    def create(rotation=None, translation=(0.0, 0.0, 0.0),
               scale=(1.0, 1.0, 1.0)) -> "VolumeTransform":
        if rotation is None:
            rotation = np.eye(3)
        return VolumeTransform(rotation, translation, scale)

    def inverse_transform_position(self, p):
        return ((_f32(p) - self.translation) @ self.rotation.T) / self.scale

    def inverse_transform_vector(self, v):
        """Inverse-rotate and inverse-scale a vector."""
        return (_f32(v) @ self.rotation.T) / self.scale

    def world_to_uvw(self, p):
        return self.inverse_transform_position(p) + np.float32(0.5)

    def local_light_direction(self, light: DirLight) -> np.ndarray:
        """Normalized light direction in volume-local space
        (`LightingShaderUtils.cpp:160-177`)."""
        d = self.inverse_transform_vector(light.direction)
        return d / np.linalg.norm(d)

    def local_clip_plane(self, plane: ClipPlane) -> ClipPlane:
        """Clip plane in UVW space (`LightingShaderUtils.cpp:205-220`)."""
        center = self.world_to_uvw(plane.center)
        direction = (plane.direction @ self.rotation.T) * self.scale
        direction = direction / np.maximum(
            np.linalg.norm(direction), np.float32(1e-12)
        )
        return ClipPlane(center, direction)


@dataclasses.dataclass
class Camera:
    """Pinhole camera: ``rotation`` rows are (right, up, forward) in world
    space; ``tan_half_fov`` sets the horizontal field of view."""

    position: np.ndarray
    rotation: np.ndarray
    tan_half_fov: np.ndarray | float = 0.5773502691896

    def __post_init__(self):
        self.position = _f32(self.position)
        self.rotation = _f32(self.rotation)
        self.tan_half_fov = _f32(self.tan_half_fov)

    @staticmethod
    def create(position, rotation=None, fov_degrees=60.0) -> "Camera":
        if rotation is None:
            rotation = np.eye(3)
        return Camera(position, rotation,
                      np.tan(np.radians(fov_degrees) / 2.0))

    @staticmethod
    def look_at(position, target, up=(0.0, 0.0, 1.0),
                fov_degrees=60.0) -> "Camera":
        """Camera at ``position`` looking at ``target``."""
        with span(CAMERA):
            position = np.asarray(position, np.float64)
            forward = np.asarray(target, np.float64) - position
            forward = forward / np.linalg.norm(forward)
            up = np.asarray(up, np.float64)
            right = np.cross(forward, up)
            nrm = np.linalg.norm(right)
            if nrm < 1e-8:  # forward parallel to up: pick any perpendicular
                right = np.cross(forward, np.array([1.0, 0.0, 0.0]))
                nrm = np.linalg.norm(right)
            right = right / nrm
            true_up = np.cross(right, forward)
            rot = np.stack([right, true_up, forward])
            return Camera.create(position, rot, fov_degrees)


def orbit_camera(angle, radius, height=0.0, target=(0.0, 0.0, 0.0),
                 fov_degrees=60.0) -> Camera:
    """Camera orbiting ``target`` in the XY plane."""
    angle = float(angle)
    pos = (
        float(target[0]) + radius * np.cos(angle),
        float(target[1]) + radius * np.sin(angle),
        float(target[2]) + height,
    )
    return Camera.look_at(pos, target, fov_degrees=fov_degrees)
