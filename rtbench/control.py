#!/usr/bin/env python3
"""Read a cell's check under its control and its planted faults, through
the run's own session and decision.

    python3 rtbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--plants none control stale ...] [--seconds 3]

For each plant and seed it runs the cell's session in this one process, at
the cell's own sizes, with a short window: ``none`` is the program as it
stands, ``control`` the plain reference in bfloat16 in the program's place
(``faults.Control``), any other name a fault of ``faults.py`` planted under
the program's entry.  It prints one JSON line each: ``correct`` and
``failed`` as ``run.py`` decides them, and each number the check compared
beside its limit.  The default plants are ``none``, ``control`` and the
faults the cell's frames can show (``faults.applicable``).  A cell over
several cards runs here in one process (``frames_parallel`` on a world of
one, which gathers nothing), where ``nogather`` stands the call's first
frame in for the others.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtbench import faults, run, session, spec, traffic  # noqa: E402


def read(cell, seed: int, plant: str, seconds: float, device: str,
         kind: str) -> dict:
    """One short run of ``cell`` with ``plant`` ("none": nothing) planted,
    judged as ``run.py`` judges a run."""
    if device != "cpu":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    rep = session.run(cell, seed, seconds, False, device, time.time(),
                      plant=None if plant == "none" else plant)
    rep.pop("context")
    args = argparse.Namespace(trace=0, rehearse=device == "cpu")
    out = run.assemble(cell, [rep], args, kind)
    c = rep["check"]
    return {"workload": cell.name, "seed": seed, "plant": plant,
            "correct": out["correct"], "failed": out["failed"],
            "frames_checked": c["frames_checked"],
            "pixels": c["pixels_checked"], "mesh_pixels": c["mesh_pixels"],
            "shadow_pixels": c["shadow_pixels"],
            "check_s": c["seconds"], "checks": out["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--plants", nargs="+", default=None,
                    choices=("none",) + faults.PLANTS)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rehearse", action="store_true",
                    help="a tiny size on the CPU")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if args.rehearse:
        cell.traffic, cell.config = traffic.rehearsal(cell.traffic,
                                                      cell.config)
        device, kind = "cpu", "cpu"
    else:
        import torch
        device = "cuda:0"
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(0)
    plants = args.plants or (("none", faults.CONTROL)
                             + faults.applicable(cell.traffic))
    for plant in plants:
        for seed in args.seeds:
            print(json.dumps(read(cell, seed, plant, args.seconds, device,
                                  kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
