"""The one traffic generator: what each iteration of a cell does, from a
configuration and a traffic mix (`traffic/<mix>.json`).

A mix is data. A frames mix gives the camera's path (fixed, an orbit
about the target, or a dolly along the view direction, back and forth)
and any of the viewer's other inputs as tracks, each stepping one of the
renderer's setters every ``every`` iterations, back and forth between two
bounds: the window's center and width, the clip plane's position along
its normal, and a light's direction, turned about an axis. A mix may also
set the renderer's options that the reference follows (``renderer``). A
fit mix keeps the configuration's camera and describes the optimizer
step. Iteration ``i``'s state is a pure function of ``i``, so the harness
and the reference work it out alike. The keys of a mix are listed in
`rmbench/README.md`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# the renderer's options a mix may set: those the reference follows
RENDERER_OPTIONS = ("jitter", "early_termination", "empty_space_skipping")


@dataclasses.dataclass(frozen=True)
class State:
    """What iteration ``i`` renders: the camera (world position, target,
    horizontal field of view in degrees), the window (center, width), the
    world clip plane (center, unit normal) or None, and the lights (world
    direction, intensity)."""

    position: tuple
    target: tuple
    fov_deg: float
    window_center: float
    window_width: float
    clip: tuple | None
    lights: tuple


def bounce(i: int, start: float, lo: float, hi: float, step: float) -> float:
    """The value after ``i`` steps of ``step`` from ``start``, turning
    back at ``lo`` and ``hi`` (a triangle wave)."""
    n = int(round((hi - lo) / step))
    k = int(round((start - lo) / step)) + i
    k %= 2 * n
    if k > n:
        k = 2 * n - k
    return lo + k * step


def track(spec: dict | None, i: int) -> float:
    """The offset a track (``every``, ``step``, ``min_offset``,
    ``max_offset``) gives iteration ``i``: 0 before the window (``i`` <
    0), then a step every ``every`` iterations, back and forth."""
    if not spec or i < 0:
        return 0.0
    return bounce(i // int(spec.get("every", 1)), 0.0,
                  float(spec["min_offset"]), float(spec["max_offset"]),
                  float(spec["step"]))


def world_scale(config: dict) -> np.ndarray:
    """The proxy cube's world size per axis: the volume's extent in cm
    (dimensions times spacing in mm, over 10) where the configuration
    gives a spacing, the unit cube otherwise (the renderer's rule)."""
    spacing = config.get("spacing_mm")
    if spacing is None:
        return np.ones(3)
    return np.asarray(config["dims"], np.float64) * np.asarray(spacing) / 10.0


def base_camera(config: dict):
    """(position, target, fov) of the configuration's camera: a world
    ``position``, or an ``azimuth_deg``/``elevation_deg``/``distance``
    orbit point whose distance counts the volume's largest world extent
    when ``distance_in_extents`` is set."""
    cam = config["camera"]
    target = tuple(float(x) for x in cam.get("target", (0.0, 0.0, 0.0)))
    if "position" in cam:
        return tuple(float(x) for x in cam["position"]), target, \
            float(cam["fov_deg"])
    d = float(cam["distance"])
    if cam.get("distance_in_extents"):
        d *= float(world_scale(config).max())
    return orbit_point(cam["azimuth_deg"], cam["elevation_deg"], d,
                       target), target, float(cam["fov_deg"])


def orbit_point(azimuth_deg, elevation_deg, distance, target=(0, 0, 0)):
    """The point at ``distance`` from ``target`` at the azimuth and
    elevation given in degrees (the render CLI's `orbit_camera`
    formula)."""
    az, el = math.radians(azimuth_deg), math.radians(elevation_deg)
    return (float(target[0]) + distance * math.cos(el) * math.sin(az),
            float(target[1]) - distance * math.cos(el) * math.cos(az),
            float(target[2]) + distance * math.sin(el))


def rotate(v, axis, deg: float) -> tuple:
    """``v`` turned by ``deg`` degrees about ``axis`` (Rodrigues)."""
    v = np.asarray(v, np.float64)
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    a = math.radians(deg)
    out = (v * math.cos(a) + np.cross(k, v) * math.sin(a)
           + k * np.dot(k, v) * (1.0 - math.cos(a)))
    return tuple(float(x) for x in out)


def renderer_options(config: dict, traffic: dict) -> dict:
    """The configuration's renderer options with the mix's over them; a
    mix may set only those the reference follows."""
    extra = traffic.get("renderer") or {}
    unknown = set(extra) - set(RENDERER_OPTIONS)
    if unknown:
        raise ValueError(f"a mix may set only {RENDERER_OPTIONS} of the "
                         f"renderer (the reference follows no other); got "
                         f"{sorted(unknown)}")
    return dict(config["renderer"], **extra)


class Generator:
    """Iteration states of one cell."""

    def __init__(self, config: dict, traffic: dict):
        self.config, self.traffic = config, traffic
        self.loop = traffic["loop"]
        if self.loop not in ("frames", "fit"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self.center0 = float(config["window"][0])
        self.width0 = float(config["window"][1])
        self.cam = dict(traffic.get("camera") or {"path": "fixed"})
        pos, target, fov = base_camera(config)
        if "position" in self.cam:  # the mix brings its own camera
            pos = tuple(float(x) for x in self.cam["position"])
            target = tuple(float(x) for x in self.cam.get("target", target))
            fov = float(self.cam.get("fov_deg", fov))
        self.pos0, self.target, self.fov = np.asarray(pos), target, fov
        rel = self.pos0 - np.asarray(target)
        self.distance = float(np.linalg.norm(rel))
        self.azimuth0 = math.degrees(math.atan2(rel[0], -rel[1]))
        self.elevation = math.degrees(math.asin(rel[2] / self.distance))
        self.clip = traffic.get("clip")
        self.window = traffic.get("window")
        self.window_width = traffic.get("window_width")
        self.light = traffic.get("light")

    def _position(self, i: int) -> tuple:
        path = self.cam.get("path", "fixed")
        if path == "fixed":
            return tuple(float(x) for x in self.pos0)
        if path == "orbit":
            az = self.azimuth0 + float(self.cam["deg_per_iteration"]) * i
            return orbit_point(az, self.elevation, self.distance, self.target)
        if path == "dolly":
            fwd = np.asarray(self.target) - self.pos0
            fwd = fwd / np.linalg.norm(fwd)
            s = bounce(i, 0.0, 0.0, float(self.cam["span"]),
                       float(self.cam["per_iteration"]))
            return tuple(float(x) for x in self.pos0 + fwd * s)
        raise ValueError(f"unknown camera path {path!r}")

    def _clip(self, i: int):
        c = self.clip
        if not c:
            return None
        d = np.asarray(c["direction"], np.float64)
        d = d / np.linalg.norm(d)
        width = float(np.sum(np.abs(d) * world_scale(self.config)))
        t = bounce(max(i, 0), float(c["from"]), float(c["from"]),
                   float(c["to"]), float(c["per_iteration"]))
        return tuple(float(x) for x in d * (t - 0.5) * width), \
            tuple(float(x) for x in d)

    def _lights(self, i: int) -> tuple:
        out = []
        for k, li in enumerate(self.config["lights"]):
            d = tuple(float(x) for x in li["direction"])
            m = self.light
            if m and int(m.get("index", 0)) == k:
                d = rotate(d, m["axis"], track(m, i))
            out.append((d, float(li["intensity"])))
        return tuple(out)

    def state(self, i: int) -> State:
        """Iteration ``i``'s state (warm-up iterations may be negative or
        lie anywhere on the path)."""
        return State(
            position=self._position(i), target=self.target, fov_deg=self.fov,
            window_center=self.center0 + track(self.window, i),
            window_width=self.width0 + track(self.window_width, i),
            clip=self._clip(i), lights=self._lights(i))
