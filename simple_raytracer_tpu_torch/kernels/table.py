"""The port's kernels by role: which implementation of each runs, and how
often.

Every hand-written kernel of ``csrc/`` has a CUDA wrapper, which checks its
operands and launches it, and a plain PyTorch twin with the same arguments
and results.  :func:`roles` lists each pair once, by the role a frame, the
ring, the train step or a probe calls it in, and every call goes through
:func:`run`, which chooses one of the two by :func:`pick`'s rule: the plain
twin for CPU tensors, the wrapper for CUDA tensors, ValueError for any
other device.  Two roles have an input rule besides, beside their entries:

* ``plan``: a range-only plan (:func:`kernels.plan.range_only`) is built
  plain; csrc/plan.cu builds list plans;
* ``shade``: shading with a ``record`` given (the soft branch's and the
  ring's) or a gradient to carry (diff/render.py) is plain; csrc/shade.cu
  gathers its own records by id and has no backward.

:func:`using` takes other functions for some roles within a scope: spies
that record a role's arguments, stand-ins of the tests, and
:func:`plain`, the all-plain mapping, under which a frame on the card runs
no kernel of ``csrc/`` (the reference images of ``chip_smoke.py``).
Outside such a scope nothing is overridden.

Each call of a role's wrapper or twin counts in utils/metrics.py's
registry, once it returns, under ``module.function.calls`` of what ran
(``.plans`` for the planner: ``plan.cull_cuda.plans``,
``plan.cull_plain.plans``); a stand-in counts nothing.  The wrappers count
their own launches where they launch (``module.function.launches``), which
:func:`launches` reads.  K7's plain twin is K2′'s, so the ``anyhit`` and
``anyhit_pages`` roles share the plain key
``anyhit.tiled_anyhit_plain.calls``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.metrics import count, counts


class Role(NamedTuple):
    """One kernel: its CUDA wrapper, its plain twin, the input rule that
    sends a call on the card to the twin (None: none), and what a call
    counts as."""

    cuda: Callable
    plain: Callable
    rule: Optional[Callable] = None
    unit: str = "calls"

    def key(self, fn: Callable) -> str:
        """The registry key a call of ``fn`` (the wrapper or the twin)
        counts under."""
        return f"{fn.__module__.rpartition('.')[2]}.{fn.__name__}.{self.unit}"


@functools.lru_cache(maxsize=None)
def roles() -> dict:
    """Every kernel of the port by role: its :class:`Role`."""
    from . import anyhit as ah, nearest as nr, paged, plan as pl, prepass
    from ..probes import attr, fixed
    from ..render import integrator

    def range_only_plan(prep, maxv: int, wb: int, *args, **kw) -> bool:
        return pl.range_only(maxv, prep.num_blocks // wb)

    def record_or_gradient(scene, cfg, origin, direction, t, tri_idx,
                           light_pos, shadow_fn=None, record=None) -> bool:
        if record is not None:
            return True
        inputs = (scene.verts, scene.vnormals, scene.tri_normal, scene.uvs,
                  scene.obj_color, scene.obj_ambient, scene.obj_specular,
                  scene.obj_shininess, scene.tex_data, origin, direction, t,
                  light_pos)
        return torch.is_grad_enabled() and any(
            torch.is_tensor(x) and x.requires_grad for x in inputs)
    return {
        "nearest_shaded": Role(nr.tiled_nearest_shaded,
                               nr.tiled_nearest_shaded_plain),
        "nearest_attrs": Role(nr.tiled_nearest_attrs,
                              nr.tiled_nearest_attrs_plain),
        "nearest_rays": Role(nr.tiled_nearest_rays,
                             nr.tiled_nearest_rays_plain),
        "nearest_rays_attrs": Role(nr.tiled_nearest_rays_attrs,
                                   nr.tiled_nearest_rays_attrs_plain),
        "nearest_grouped": Role(nr.tiled_nearest_grouped,
                                nr.tiled_nearest_grouped_plain),
        "prepass": Role(prepass.tiled_prepass, prepass.tiled_prepass_plain),
        "anyhit_from_t": Role(ah.tiled_anyhit_from_t,
                              ah.tiled_anyhit_from_t_plain),
        "anyhit": Role(ah.tiled_anyhit, ah.tiled_anyhit_plain),
        "anyhit_grouped": Role(ah.tiled_anyhit_grouped,
                               ah.tiled_anyhit_grouped_plain),
        "nearest_pages": Role(paged.tiled_nearest, paged.tiled_nearest_plain),
        "anyhit_pages": Role(paged.tiled_anyhit, paged.tiled_anyhit_plain),
        "plan": Role(pl.cull_cuda, pl.cull_plain, range_only_plan, "plans"),
        "camera": Role(pl.camera_cuda, pl.camera_plain),
        "tile_bounds": Role(pl.tile_bounds_cuda, pl.tile_bounds_plain),
        "shadow_bounds": Role(pl.shadow_bounds_cuda, pl.shadow_bounds_plain),
        "shade": Role(integrator.shade_cuda, integrator.shade_plain,
                      record_or_gradient),
        "attr_gather": Role(attr.attr_gather, attr.attr_gather_plain),
        "attr_window": Role(attr.attr_window, attr.attr_window_plain),
        "fixed": Role(fixed.fixed_probe, fixed.fixed_probe_plain),
    }


def _device(args, kw) -> torch.device:
    """The device of the first argument that is a tensor or has one (a
    scene, a prepared scene), positional arguments first."""
    for x in (*args, *kw.values()):
        if torch.is_tensor(x) or isinstance(getattr(x, "device", None),
                                            torch.device):
            return x.device
    raise ValueError("no tensor argument to choose a kernel by")


def pick(role: str, *args, **kw) -> Callable:
    """The function :func:`run` takes for this call of ``role`` with no
    override: the plain twin for CPU tensors or where the role's rule says
    so, the CUDA wrapper for CUDA tensors.  Raises ValueError for any other
    device."""
    entry = roles()[role]
    dev = _device(args, kw)
    if dev.type == "cpu":
        return entry.plain
    if dev.type != "cuda":
        raise ValueError(f"no {role} kernel for device {dev}")
    if entry.rule is not None and entry.rule(*args, **kw):
        return entry.plain
    return entry.cuda


# the roles run by other functions within the innermost using() scope
_override: dict = {}


def _call(role: str, fn: Callable, args, kw):
    """``fn(*args, **kw)``, counted once it returns if ``fn`` is the role's
    wrapper or twin."""
    out = fn(*args, **kw)
    entry = roles()[role]
    if fn is entry.cuda or fn is entry.plain:
        count(entry.key(fn))
    return out


def run(role: str, *args, **kw):
    """Call ``role`` on the arguments, by the scope's override or
    :func:`pick`, and count the call."""
    fn = _override.get(role) or pick(role, *args, **kw)
    return _call(role, fn, args, kw)


def spy(role: str, store: list) -> Callable:
    """A stand-in for ``role`` (for :func:`using`) that appends each call's
    positional arguments to ``store`` and runs :func:`pick`'s choice,
    counted as that."""
    def record(*args, **kw):
        store.append(args)
        return _call(role, pick(role, *args, **kw), args, kw)
    return record


@contextlib.contextmanager
def using(mapping: dict):
    """Within the scope, run ``mapping[role]`` for each role it names in
    place of the table's choice; an inner scope overrides an outer one
    role by role."""
    global _override
    outer = _override
    _override = {**outer, **mapping}
    try:
        yield
    finally:
        _override = outer


def plain() -> dict:
    """The mapping of every role to its plain twin (for :func:`using`)."""
    return {role: entry.plain for role, entry in roles().items()}


def calls(twin: bool = False) -> dict:
    """The calls counted so far of each role's CUDA wrapper (``twin``: of
    its plain twin), by role."""
    now = counts()
    return {role: now.get(e.key(e.plain if twin else e.cuda), 0)
            for role, e in roles().items()}


def launches() -> dict:
    """The launches each role's CUDA wrapper has counted so far where it
    launches (all its keys ``module.function.launches[.*]``), by role."""
    now = counts()
    out = {}
    for role, e in roles().items():
        key = e.key(e.cuda).rpartition(".")[0] + ".launches"
        out[role] = sum(n for k, n in now.items()
                        if k == key or k.startswith(key + "."))
    return out
