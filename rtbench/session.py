"""One process of a run: build the scene from the seed, prepare it on the
card, warm up the cell's own frames, run the closed loop for the window,
then check a sample of the delivered frames against the plain reference.

A cell whose traffic asks for several processes runs one session per card
(``launch.py``), joined in one ``torch.distributed`` group; the first
process times the calls, keeps the frames and checks them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from . import traffic as tr
from .reference.render import Reference
from .scenes.port import to_port
from .trace import FRAME_SPAN, Trace

JAX_NAMES = ("jax", "jaxlib", "flax", "simple_raytracer_tpu")
# calls of the cell's own frames before the window
WARMUP_CALLS = 6
# a traced run: calls before the card's slice, its calls, the host's slice
TRACE_SKIP, TRACE_CALLS, TRACE_HOST_CALLS = 10, 24, 6
# pixels of each checked frame compared with the reference
CHECK_PIXELS = 65536


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    JAX_NAMES, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (rtbench/metrics/__init__.py)."""

    trace: Optional[Trace]
    spans: dict
    rays_per_frame: int
    triangles: int
    light_samples: int
    frames_traced: int


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_config(config: dict, traffic: dict):
    import simple_raytracer_tpu_torch as sr
    return sr.default_config().replace(
        mode="tiled", bvh=sr.BVHConfig(split=config["bvh_split"]),
        camera=sr.CameraConfig(width=int(traffic["width"]),
                               height=int(traffic["height"]),
                               focal=float(traffic["focal"])),
        light=sr.LightConfig(position=tuple(config["light"]),
                             num_samples=int(traffic["light_samples"]),
                             enable_shadows=bool(traffic["shadows"])),
        shading=sr.ShadingConfig(
            smooth_normals=bool(config["smooth_normals"])))


class Entry:
    """The program's public entry that the window drives: ``render`` (one
    view a call) or ``frames_parallel`` (one view per process a call, the
    frames gathered).  A call returns the frames on the host of the first
    process ([F, H, W, 3] uint8), None on the others."""

    def __init__(self, name: str, prep, cfg, light, mesh=None, lead=True):
        self.name, self.prep, self.cfg = name, prep, cfg
        self.light, self.mesh, self.lead = light, mesh, lead

    def __call__(self, views: List[np.ndarray], call: int):
        if self.name == "render":
            from simple_raytracer_tpu_torch.render import renderer
            img = renderer.render(self.prep, self.cfg, self.light,
                                  view_matrix=views[0])
            return img.cpu()[None]
        from simple_raytracer_tpu_torch.driver import animation
        out = animation.frames_parallel(self.prep, self.cfg, np.stack(views),
                                        self.light, self.mesh, "pp")
        return out.cpu() if self.lead else None


class Reservoir:
    """A uniform sample of ``k`` calls of the window, drawn from the seed
    (Algorithm R), with their frames."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, call: int, frames) -> None:
        if len(self.items) < self.k:
            self.items.append((call, frames))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (call, frames)
        self.seen += 1


class Tracer:
    """``torch.profiler`` over two slices of the window, after ``skip``
    calls: ``calls`` calls with the card's activity alone, which the
    metrics read (recording every host operator would double a frame's
    host time and inflate the card's idle share), then ``host_calls``
    calls with the host's operators too, only to name what the host was
    doing in the card's idle gaps.  Off when ``calls`` is 0; on the CPU
    (a rehearsal) both slices trace the host."""

    def __init__(self, calls: int, skip: int, host_calls: int, device):
        self.calls, self.skip, self.host_calls = calls, skip, host_calls
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.traces = {}
        self.end = skip + calls + host_calls if calls > 0 else 0

    def pending(self, c: int) -> bool:
        return c < self.end

    def span(self):
        return torch.profiler.record_function(FRAME_SPAN)

    def before(self, c: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        if self.end and c in (self.skip, self.skip + self.calls):
            host = c != self.skip or not self.cuda
            acts = ([ProfilerActivity.CPU] if host else []) + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()

    def after(self, c: int, frames_per_call: int) -> None:
        for first, n, key in ((self.skip, self.calls, "card"),
                              (self.skip + self.calls, self.host_calls,
                               "host")):
            if self.end and n and c == first + n - 1:
                self.prof.stop()
                fd, path = tempfile.mkstemp(prefix="rtbench_trace_",
                                            suffix=".json")
                os.close(fd)
                try:
                    self.prof.export_chrome_trace(path)
                    self.traces[key] = Trace.load(path, n, frames_per_call)
                finally:
                    os.unlink(path)
                self.prof = None

    def breakdown(self) -> Optional[dict]:
        if "card" not in self.traces:
            return None
        host = self.traces.get("host")
        return {"device_ops": self.traces["card"].device_ops(),
                "idle_gaps": host.idle_gaps() if host is not None else []}


def pixel_sample(seed: int, frame: int, total: int, m: int) -> np.ndarray:
    """``m`` distinct row-major pixel ids of one frame, drawn from the
    seed and the frame's index."""
    if m >= total:
        return np.arange(total)
    return np.sort(tr.seed_rng(seed, 2, frame).choice(total, m,
                                                      replace=False))


# the numbers the check can compare: the share of checked pixels more than
# one level off, over every checked pixel, over those whose reference ray
# hits the mesh (object 0), and over those the reference shadows
CLASSES = ("bad_px_pct", "bad_mesh_px_pct", "bad_shadow_px_pct")


def off_by_more_than_one(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1) > 1


def classes(obj: np.ndarray, shadowed: np.ndarray) -> dict:
    return {"bad_px_pct": np.ones_like(shadowed), "bad_mesh_px_pct": obj == 0,
            "bad_shadow_px_pct": shadowed}


def check_frames(scene, traffic: dict, config: dict, views, kept, seed: int,
                 device, limits: dict) -> dict:
    """The kept calls' frames against the plain reference: for each number
    of CLASSES, the share of its checked pixels more than one level off in
    any channel, and the frames whose own share passes a limit of
    ``limits``.  A frame of the wrong shape or type counts every pixel
    off."""
    ref = Reference(scene, device)
    W, H = int(traffic["width"]), int(traffic["height"])
    vpc = int(traffic["views_per_call"])
    bad = dict.fromkeys(CLASSES, 0)
    seen = dict.fromkeys(CLASSES, 0)
    failed = frames = 0
    for call, imgs in sorted(kept, key=lambda x: x[0]):
        for i in range(vpc):
            f = call * vpc + i
            px = pixel_sample(seed, f, W * H, CHECK_PIXELS)
            want, obj, shadowed = ref.classified(
                tr.frame(traffic, config, views(f)), px)
            if (imgs is not None and tuple(imgs.shape) == (vpc, H, W, 3)
                    and imgs.dtype == torch.uint8):
                off = off_by_more_than_one(
                    imgs[i].numpy().reshape(-1, 3)[px], want)
            else:
                off = np.ones(len(px), bool)
            over = False
            for name, sel in classes(obj, shadowed).items():
                b, n = int(off[sel].sum()), int(sel.sum())
                bad[name] += b
                seen[name] += n
                over |= name in limits and n > 0 and (
                    100.0 * b / n > float(limits[name]))
            frames += 1
            failed += int(over)
    out = {name: 100.0 * bad[name] / seen[name] if seen[name] else 0.0
           for name in CLASSES}
    out.update(frames_checked=frames, pixels_checked=seen["bad_px_pct"],
               mesh_pixels=seen["bad_mesh_px_pct"],
               shadow_pixels=seen["bad_shadow_px_pct"], frames_failed=failed)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, rank: int = 0, world: int = 1, port: int = 0,
        plant: Optional[str] = None) -> dict:
    """One process of a run; returns its report (the first process's holds
    the frames' numbers and the check)."""
    config, traffic = cell.config, cell.traffic
    lead = rank == 0
    spans = {}
    scene = cell.scene_builder().build(config, seed)
    cfg = program_config(config, traffic)
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    port_scene = to_port(scene)
    t0 = time.perf_counter()
    prep = prepare(port_scene, cfg, device=device)
    sync(device)
    spans["prepare"] = time.perf_counter() - t0
    mesh = flag_group = None
    if world > 1:
        from simple_raytracer_tpu_torch.dist.multihost import init_distributed
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank, device=device)
    if traffic["entry"] == "frames_parallel":
        # a process alone (control.py) forms a world of one
        from simple_raytracer_tpu_torch.dist import make_mesh
        mesh = make_mesh(world, ("pp",), device=device)
    if world > 1:
        flag_group = torch.distributed.new_group(backend="gloo")
    light = tuple(float(x) for x in config["light"])
    entry = Entry(traffic["entry"], prep, cfg, light, mesh, lead)
    if plant:
        from . import faults
        entry = (faults.Control(scene, traffic, config, seed, device, lead)
                 if plant == faults.CONTROL
                 else faults.plant(plant, entry, world))
    views = tr.Views(traffic, config, seed)
    vpc = int(traffic["views_per_call"])

    def call_views(c: int):
        return [views(c * vpc + i) for i in range(vpc)]

    # warm-up: the cell's own frames, from the arc's frames before the window
    for c in range(-WARMUP_CALLS, 0):
        entry(call_views(c), c)
    sync(device)
    if world > 1:
        torch.distributed.barrier()
    setup_s = time.time() - t_start

    tracer = Tracer(TRACE_CALLS if trace else 0, TRACE_SKIP,
                    TRACE_HOST_CALLS, device)
    per_call = max(1, vpc // world)
    keep = Reservoir(max(1, int(traffic["check_frames"]) // vpc),
                     tr.seed_rng(seed, 3))
    times = []
    flag = torch.ones(1, dtype=torch.int32)
    start = time.perf_counter()
    c = 0
    while True:
        if lead:
            go = (c == 0 or time.perf_counter() - start < seconds
                  or tracer.pending(c))
            flag[0] = int(go)
        if world > 1:
            torch.distributed.broadcast(flag, 0, group=flag_group)
        if not flag[0]:
            break
        vs = call_views(c)
        tracer.before(c)
        a = time.perf_counter()
        with tracer.span():
            frames = entry(vs, c)
        b = time.perf_counter()
        tracer.after(c, per_call)
        if lead:
            times.append((a, b))
            keep.offer(c, frames)
        c += 1
    sync(device)
    dev = torch.device(device)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    trace_obj = tracer.traces.get("card")
    if world > 1:
        torch.distributed.barrier()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    report = {"rank": rank, "memory_peak_bytes": int(peak), "calls": c}
    if trace_obj is not None:
        report["busy_s"] = trace_obj.busy_us() / 1e6
        report["window_s"] = trace_obj.window_us / 1e6
        report["breakdown"] = tracer.breakdown()
    if not lead:
        report["jax_modules"] = jax_modules()
        return report

    del entry, prep, port_scene, mesh
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    W, H = int(traffic["width"]), int(traffic["height"])
    frames_done = len(times) * vpc
    window = times[-1][1] - times[0][0]
    ms = np.repeat([1e3 * (b - a) for a, b in times], vpc)
    report.update(
        setup_s=setup_s, frames=frames_done, window_s_measured=window,
        rays_per_s=frames_done * W * H / window,
        frame_ms_p95=float(np.percentile(ms, 95)),
        frame_ms_p50=float(np.percentile(ms, 50)),
        context=Context(trace_obj, spans, W * H, scene.num_triangles,
                        int(traffic["light_samples"]),
                        trace_obj.frames if trace_obj is not None else 0))
    t0 = time.perf_counter()
    report["check"] = check_frames(scene, traffic, config, views, keep.items,
                                   seed, device, cell.limits)
    report["check"]["seconds"] = time.perf_counter() - t0
    report["jax_modules"] = jax_modules()
    return report


def worker_main(cell, args) -> int:
    """A process of a multi-process run: its report as one JSON line on
    standard output (the first process's frames' numbers included)."""
    device = ("cpu" if args.rehearse else f"cuda:{args.worker_rank}")
    if device != "cpu":
        torch.cuda.set_device(device)
    rep = run(cell, args.seed, args.seconds, bool(args.trace), device,
              args.t_start, args.worker_rank, args.worker_world,
              args.worker_port, args.plant)
    ctx = rep.pop("context", None)
    if ctx is not None:
        rep["per_layer"] = read_per_layer(cell, ctx)
    print(json.dumps(rep), flush=True)
    return 0


def read_per_layer(cell, ctx: Context) -> dict:
    from .spec import metric_module
    out = {}
    for m in cell.per_layer:
        v = metric_module(m["name"]).read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
