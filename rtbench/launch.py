"""A run over several cards: one process per card, each a session of its
own (``run.py`` with the hidden ``--worker-*`` arguments), joined in one
``torch.distributed`` group at ``tcp://localhost:<a free port>``.  The
parent touches no card: it starts the processes, waits for every one, and
reads each one's report, the last line of its standard output."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")
WAIT_S = 330.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(cell, args, t_start: float) -> list:
    """Start one worker per card of the cell, wait for all (ending the rest
    when one fails or the time runs out), and return their reports by rank;
    raises RuntimeError when a worker fails."""
    n = cell.chips
    port = free_port()
    base = [sys.executable, RUN, "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace), "--worker-world", str(n),
            "--worker-port", str(port), "--t-start", repr(t_start)]
    if args.rehearse:
        base.append("--rehearse")
    if args.plant:
        base += ["--plant", args.plant]
    procs = [subprocess.Popen(base + ["--worker-rank", str(r)],
                              stdout=subprocess.PIPE, text=True)
             for r in range(n)]
    deadline = time.time() + WAIT_S
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad or time.time() > deadline:
                failed = (f"worker {bad[0]} exited {procs[bad[0]].returncode}"
                          if bad else "workers ran out of time")
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if failed or any(codes):
        raise RuntimeError(failed or f"worker exit codes {codes}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]
