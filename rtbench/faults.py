"""Faults planted under the timed path, and the control put in the
program's place, for the runs that see the check fail.  Only a rehearsal
(``run.py --rehearse --plant <name>``) or ``control.py`` plants one.

* ``stale``: the entry returns its first call's frames every call (a step
  that leaves its state unchanged);
* ``half_lower``, ``half_upper``: the lower or the upper half of every
  frame is left out (background);
* ``nogather``: the frames' all-gather between processes is left out, each
  process's own frames stand in for every process's (in a process alone,
  which has no exchange to leave out, the call's first frame stands in for
  the others, as the first of several processes would see it);
* ``altered``: every frame's hit pixels come out two levels redder;
* ``noshadow``: the frames are rendered without their shadows (a layer
  left out);
* ``control``: the plain reference in bfloat16, the precision below the
  configuration's float32, in the program's place (``Control``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FAULTS = ("stale", "half_lower", "half_upper", "nogather", "altered",
          "noshadow")
CONTROL = "control"
PLANTS = FAULTS + (CONTROL,)
BACKGROUND = (173, 216, 230)


def applicable(traffic: dict) -> tuple:
    """The faults a cell's frames can show: ``nogather`` where a call
    gathers several views, ``noshadow`` where the shadow is in view."""
    skip = set()
    if int(traffic["views_per_call"]) == 1:
        skip.add("nogather")
    if not traffic.get("expect", {}).get("shadow_in_view", True):
        skip.add("noshadow")
    return tuple(f for f in FAULTS if f not in skip)


def _is_background(x: torch.Tensor) -> torch.Tensor:
    return (x == torch.tensor(BACKGROUND, dtype=x.dtype)).all(-1)


class Planted:
    def __init__(self, fault: str, entry, alone: bool):
        self.fault, self.entry, self.first = fault, entry, None
        self.alone = alone

    def __call__(self, views, call: int):
        out = self.entry(views, call)
        if out is None or self.fault == "noshadow":
            return out
        if self.fault == "nogather":
            return out[:1].expand_as(out).clone() if self.alone else out
        if self.fault == "stale":
            if self.first is None:
                self.first = out
            return self.first
        out = out.clone()
        H = out.shape[1]
        if self.fault in ("half_lower", "half_upper"):
            rows = (slice(H // 2, None) if self.fault == "half_lower"
                    else slice(None, H // 2))
            out[:, rows] = torch.tensor(BACKGROUND, dtype=out.dtype)
        elif self.fault == "altered":
            red = (out[..., 0].int() + 2).clamp(max=255).to(out.dtype)
            out[..., 0] = torch.where(_is_background(out), out[..., 0], red)
        return out


def plant(fault: str, entry, world: int):
    """``entry`` with ``fault`` planted underneath or around it."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "noshadow":
        entry.cfg = entry.cfg.replace(light=dataclasses.replace(
            entry.cfg.light, enable_shadows=False))
    if fault == "nogather" and world > 1:
        from simple_raytracer_tpu_torch.dist import sharding
        sharding.Axis.all_gather = (
            lambda self, x: torch.cat([x.contiguous()] * self.size))
    return Planted(fault, entry, alone=world == 1)


class Control:
    """The control: the plain reference computed in bfloat16, in the
    program's place.  A call returns what the program's entry would, [F, H,
    W, 3] uint8 on the first process's host (None on the others), holding
    the reference's pixels at the pixels the check draws for each frame
    (``session.pixel_sample``) and the background elsewhere, which the
    check never reads.  A warm-up call (``call`` < 0) computes nothing."""

    def __init__(self, scene, traffic: dict, config: dict, seed: int,
                 device, lead: bool = True):
        from .reference.render import Reference
        self.ref = Reference(scene, device, dtype=torch.bfloat16)
        self.traffic, self.config, self.seed = traffic, config, seed
        self.lead = lead

    def __call__(self, views, call: int):
        from . import traffic as tr
        from .session import CHECK_PIXELS, pixel_sample
        if not self.lead:
            return None
        W, H = int(self.traffic["width"]), int(self.traffic["height"])
        out = np.empty((len(views), H * W, 3), np.uint8)
        out[:] = BACKGROUND
        if call >= 0:
            for i, view in enumerate(views):
                px = pixel_sample(self.seed, call * len(views) + i, W * H,
                                  CHECK_PIXELS)
                out[i, px] = self.ref.pixels(
                    tr.frame(self.traffic, self.config, view), px)
        return torch.from_numpy(out.reshape(len(views), H, W, 3))
