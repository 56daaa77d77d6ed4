"""The one traffic generator: a mix's parameters and the seed -> the view
of every frame, and what each frame asks of the renderer.

The camera starts from the cell's view (at the origin, looking along +z)
and swings on a yaw arc about the configuration's ``pivot`` (the mesh's
centre): frame f looks from yaw ``amplitude_deg * sin(2 pi f / period_frames
+ phase)``, the phase drawn from the seed.  ``period_frames`` is not a whole
number, so no view repeats, and its cycle is short against the window, so
every seed sees the same mix of views.
"""

from __future__ import annotations

import math

import numpy as np

from .reference.render import Frame


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of (seed, stream...), for any whole-number seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def yaw_about(pivot, degrees: float) -> np.ndarray:
    """The view matrix of the origin camera turned by ``degrees`` about the
    vertical (y) axis through ``pivot``: rays start at the turned origin
    and keep looking at the pivot."""
    c = np.asarray(pivot, np.float64)
    a = math.radians(degrees)
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]])
    V = np.eye(4)
    V[:3, :3] = R
    V[:3, 3] = c - R @ c
    return V.astype(np.float32)


class Views:
    """The view of frame f of one run (f < 0: the warm-up's frames)."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        arc = traffic["arc"]
        self.amplitude = float(arc["amplitude_deg"])
        self.period = float(arc["period_frames"])
        self.pivot = config["pivot"]
        self.phase = seed_rng(seed, 1).uniform(0.0, 2.0 * math.pi)

    def yaw(self, f: int) -> float:
        return self.amplitude * math.sin(2.0 * math.pi * f / self.period
                                         + self.phase)

    def __call__(self, f: int) -> np.ndarray:
        return yaw_about(self.pivot, self.yaw(f))


def frame(traffic: dict, config: dict, view: np.ndarray) -> Frame:
    """What a frame of this mix asks, as the reference takes it."""
    return Frame(int(traffic["width"]), int(traffic["height"]),
                 float(traffic["focal"]), view, tuple(config["light"]),
                 int(traffic["light_samples"]),
                 bool(config["smooth_normals"]), bool(traffic["shadows"]))


def rehearsal(traffic: dict, config: dict, width: int = 64):
    """The mix and configuration cut to a CPU rehearsal: ``width`` pixels
    wide at the same field of view, an icosphere of 2 subdivisions."""
    k = width / float(traffic["width"])
    t = dict(traffic, width=width,
             height=max(2, round(traffic["height"] * k)),
             focal=float(traffic["focal"]) * k)
    return t, dict(config, subdivisions=2)
