"""Process-group setup for several processes (JAX ``dist/multihost.py``).

JAX starts its processes with ``jax.distributed.initialize()`` and then runs
the same ``shard_map`` code as on one host.  Here each process drives one
card (or, with ``device="cpu"``, one CPU worker) and the processes meet in
one ``torch.distributed`` process group: NCCL between cards, gloo on the
CPU.  ``torchrun --nproc-per-node N`` sets the environment that
:func:`init_distributed` reads; a process started plainly stays a world of
one, and :func:`sharding.make_mesh` gives it a group of its own, so the same
collectives run.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# the variables torchrun sets for each process
TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def backend_for(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device) -> torch.device:
    """The device this process drives: for "cuda" with no index, the card
    of its ``LOCAL_RANK`` (torchrun's; 0 without it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Join the process group if a cluster is named.

    With ``coordinator`` ("host:port") or ``num_processes``, or with
    torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK), it calls
    ``init_process_group``: a ``tcp://`` address from the arguments (the
    environment fills what they leave out), else ``env://``; NCCL for
    ``device`` "cuda" (each process on the card of its LOCAL_RANK), gloo
    for "cpu".  A repeat call is a no-op, and with neither arguments nor
    that environment it initialises nothing, as JAX's does.  Returns True
    when more than one process takes part."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = bool(coordinator) or num_processes is not None
    if not (explicit or all(k in os.environ for k in TORCHRUN_ENV)):
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if explicit:
        addr = coordinator or (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        dist.init_process_group(
            backend_for(dev), init_method=f"tcp://{addr}",
            world_size=(num_processes if num_processes is not None
                        else int(os.environ["WORLD_SIZE"])),
            rank=(process_id if process_id is not None
                  else int(os.environ["RANK"])))
    else:
        dist.init_process_group(backend_for(dev), init_method="env://")
    return dist.get_world_size() > 1


def global_mesh(axis_names: Tuple[str, ...] = ("dp",),
                shape: Optional[Tuple[int, ...]] = None, device="cuda"):
    """A mesh over every process of the group (JAX: every device of every
    process); several axes need an explicit ``shape``."""
    from .sharding import make_mesh
    if shape is None and len(axis_names) > 1:
        raise ValueError("multi-axis mesh needs an explicit shape")
    init_distributed(device=device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n, axis_names, shape, device=device)


def host_local_rows(height: int) -> Tuple[int, int]:
    """The contiguous image rows this process owns (for a frame each
    process writes its own band of): [start, end)."""
    p, n = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
            else (0, 1))
    rows = height // n
    start = p * rows
    end = height if p == n - 1 else start + rows
    return start, end
