"""The distributed paths on CPU processes (the counterpart of the JAX
package's ``dryrun_multichip``): ``n`` gloo processes on this host run one
composed DP x GP training step, one DP step, and three renders held to a
single process's, at tiny shapes, on a scene built in numpy.

    python -m simple_raytracer_tpu_torch.dist.dryrun [N]
"""

from __future__ import annotations

import queue
import socket
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, FOCAL = 32, 16, 16.0
# composed render vs one process's: the ring walks other tables, so a few
# pixels may round apart (JAX's own bar)
COMPOSED_MIN = 0.995


def free_port() -> int:
    """A free TCP port on localhost (for the processes' rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scene():
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.scene import procedural as P
    cfg = sr.default_config().replace(camera=sr.CameraConfig(
        width=WIDTH, height=HEIGHT, focal=FOCAL))
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32)
    return P.sphere_on_ground(sr.SceneManager(), 1).build(), cfg, light


def checks(n: int) -> str:
    """The five checks in this process, one of ``n`` in the group; raises
    AssertionError on a wrong value.  Returns the summary line."""
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.dist import (extract_params, make_mesh,
                                                 make_train_step,
                                                 make_train_step_composed,
                                                 render_sharded)
    from simple_raytracer_tpu_torch.dist.ring import render_composed
    from simple_raytracer_tpu_torch.driver.animation import frames_parallel
    from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    from simple_raytracer_tpu_torch.render import integrator
    from simple_raytracer_tpu_torch.render.renderer import (render,
                                                            render_radiance)
    from simple_raytracer_tpu_torch.scene.catalog import orbit_view

    scene, cfg, light = _scene()
    target, hit = render_radiance(scene, cfg, light)
    target = torch.where(hit[..., None], target, 0.0)

    # the composed DP x GP step: the ring inside the loss
    gp = 2 if n % 2 == 0 else 1
    dp = n // gp
    mesh2 = make_mesh(n, ("dp", "gp"), (dp, gp), device="cpu")
    step_c, params_c, _ = make_train_step_composed(scene, cfg, mesh2)
    params_c.light_pos = light + 10.0
    params_c.obj_color = params_c.obj_color * 0.5
    _, loss_c = step_c(params_c, target)
    loss_c = float(loss_c)
    assert np.isfinite(loss_c) and loss_c > 0, f"composed loss {loss_c}"

    # the DP step with every DiffParams field (vertex gradients too)
    mesh1 = make_mesh(n, ("dp",), device="cpu")
    step_d = make_train_step(scene, cfg, mesh=mesh1)
    params_d = extract_params(scene, light)
    params_d.verts = params_d.verts + 0.01
    _, loss_d = step_d(params_d, target)
    loss_d = float(loss_d)
    assert np.isfinite(loss_d) and loss_d > 0, f"DP loss {loss_d}"

    # the DP tiled render: equal to one process's render of the same rays
    cfg_t = cfg.replace(mode="tiled")
    prep_t = prepare(scene, cfg_t, device="cpu")
    img_t = render_sharded(prep_t, cfg_t, light, mesh1)
    o, d = primary_rays(WIDTH, HEIGHT, FOCAL)
    rad, hit = render_flat_tiled(prep_t, cfg_t, light, None,
                                 rays=(o.reshape(-1, 3), d.reshape(-1, 3)))
    ref_t = integrator.finalize_image(rad.reshape(HEIGHT, WIDTH, 3),
                                      hit.reshape(HEIGHT, WIDTH), cfg_t)
    assert torch.equal(img_t, ref_t), \
        f"DP tiled render != one process's ({(img_t != ref_t).float().mean()})"

    # the composed render (the ring over gp) against one process's
    img_c = render_composed(scene, cfg, light, mesh2)
    same = float((img_c == render(scene, cfg, light, device="cpu"))
                 .all(-1).float().mean())
    assert same >= COMPOSED_MIN, f"composed render vs one process: {same}"

    # whole frames over the processes: frame 0 equals its own render
    views = np.stack([orbit_view(a, 100.0, 0.0, 0.0)
                      for a in np.linspace(0.0, 90.0, n)])
    imgs = frames_parallel(scene, cfg, views, light, mesh1, axis="dp")
    assert imgs.shape == (n, HEIGHT, WIDTH, 3), imgs.shape
    ref_v = render(scene, cfg, light, view_matrix=views[0], device="cpu")
    assert torch.equal(imgs[0], ref_v), "frame-parallel frame 0 differs"
    return (f"dryrun_multichip({n}): composed dp{dp}xgp{gp} loss="
            f"{loss_c:.6f}, dp-only loss={loss_d:.6f}, tiled-DP/composed/"
            f"frame-parallel renders OK")


def _worker(rank: int, n: int, port: int, out) -> None:
    import torch.distributed as dist
    from simple_raytracer_tpu_torch.dist.multihost import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu")
    try:
        line = checks(n)
        if rank == 0:
            out.put(line)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> str:
    """Run :func:`checks` in ``n_devices`` gloo processes on this host;
    raises RuntimeError if any process fails or outlives ``timeout``
    seconds.  Returns the summary line."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, n_devices, port, out))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    line, deadline = None, time.monotonic() + timeout
    while line is None and time.monotonic() < deadline:
        try:
            line = out.get(timeout=1.0)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=60)
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if line is None or failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): exit codes "
                           f"{[p.exitcode for p in procs]}")
    return line


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
