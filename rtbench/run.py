#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 rtbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Builds the scene from the seed, prepares it on the card, warms up the
cell's own frames, drives the program's entry (``render``, or
``frames_parallel`` over one process per card) in a closed loop for
``--seconds``, checks a sample of the delivered frames against the plain
reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiler trace of a slice of the window.  Every
number the check compared is printed beside its limit, last on standard
error and under ``checks`` in that line.

It exits non-zero and prints no result without as many CUDA cards as the
cell asks for, without the program, or when a module of JAX or of the JAX
package is loaded.  ``--rehearse`` (tests only) runs the cell at a tiny
size on the CPU, on the program's plain versions; ``--plant`` then breaks
the timed path underneath, or puts the control in its place
(``faults.py``).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# one intra-op thread in every process (torchrun's default): with one per
# core, the host-bound frames' median moved by a third between windows
os.environ["OMP_NUM_THREADS"] = "1"
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(ROOT, "rtbench", "_cache", _sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tests only: a tiny size on the CPU")
    ap.add_argument("--plant", default=None,
                    help="tests only, with --rehearse: a fault of faults.py, "
                    "or the control")
    for name in ("--worker-rank", "--worker-world", "--worker-port"):
        ap.add_argument(name, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.plant and not args.rehearse:
        ap.error("--plant needs --rehearse")
    return args


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def assemble(cell, reports, args, kind: str) -> dict:
    """The result line from the processes' reports (rank 0's first)."""
    lead = reports[0]
    check = lead["check"]
    checks = {name: {"value": check[name], "limit": float(limit)}
              for name, limit in cell.limits.items()}
    vpc = int(cell.traffic["views_per_call"])
    expected = min(max(1, int(cell.traffic["check_frames"]) // vpc),
                   lead["calls"]) * vpc
    correct = (lead["frames"] > 0 and check["frames_checked"] == expected
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "cpu" if args.rehearse else "gpu", "kind": kind,
              "count": len(reports),
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in reports)}
    out = {"correct": bool(correct), "attempted": lead["frames"],
           "failed": check["frames_failed"]}
    if args.trace:
        metrics = lead["per_layer"]
        device["busy_s"] = sum(r["busy_s"] for r in reports) / len(reports)
        device["window_s"] = (sum(r["window_s"] for r in reports)
                              / len(reports))
    else:
        values = {"rays_per_s": lead["rays_per_s"],
                  "frame_ms_p95": lead["frame_ms_p95"],
                  "setup_s": lead["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out.update(metrics=metrics, device=device)
    if args.trace and lead.get("breakdown"):
        out["breakdown"] = lead["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from rtbench import spec, traffic
    try:
        cell = spec.resolve(args.workload)
    except (KeyError, OSError) as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    if args.rehearse:
        cell.traffic, cell.config = traffic.rehearsal(cell.traffic,
                                                      cell.config)
    else:
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"rtbench: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    try:
        import simple_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"rtbench: the program is missing: {e}", file=sys.stderr)
        return 4
    from rtbench import launch, session
    if args.worker_rank is not None:
        return session.worker_main(cell, args)

    import torch
    if cell.chips > 1:
        reports = launch.run_workers(cell, args, T_START)
    else:
        device = "cpu" if args.rehearse else "cuda:0"
        if device != "cpu":
            torch.cuda.set_device(device)
        rep = session.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START, plant=args.plant)
        rep["per_layer"] = session.read_per_layer(cell, rep.pop("context"))
        reports = [rep]
    kind = "cpu" if args.rehearse else torch.cuda.get_device_name(0)
    found = sorted(set(session.jax_modules()).union(
        *[r.get("jax_modules", []) for r in reports]))
    if found:
        print(f"rtbench: modules of JAX or of the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 5
    out = assemble(cell, reports, args, kind)
    lead = reports[0]
    print(f"rtbench: {cell.name} seed {args.seed}: {lead['frames']} frames "
          f"in {lead['window_s_measured']:.4f} s, frame ms p50 "
          f"{lead['frame_ms_p50']:.4f} p95 {lead['frame_ms_p95']:.4f}, "
          f"setup {lead['setup_s']:.4f} s; "
          f"{card_line() if not args.rehearse else 'cpu rehearsal'}",
          file=sys.stderr)
    c = lead["check"]
    print(f"rtbench: checked {c['frames_checked']} frames, "
          f"{c['pixels_checked']} pixels ({c['mesh_pixels']} on the mesh, "
          f"{c['shadow_pixels']} shadowed) in {c['seconds']:.4f} s, "
          f"{c['frames_failed']} frames over a limit", file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
