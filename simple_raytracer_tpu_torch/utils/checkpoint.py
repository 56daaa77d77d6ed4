"""Checkpoint and resume of trained parameters (JAX ``utils/checkpoint.py``).

The file is JAX's own format: a numpy ``.npz`` with the leaves as
``leaf_{i}``, the step as ``__step__`` and extra values as ``extra_{k}``,
written to a temporary file and renamed over the target, so a crash never
leaves a torn checkpoint.  The leaves of a ``DiffParams`` are its fields in
order, as JAX's pytree flattening gives them, so a checkpoint written by
one package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _leaves(params) -> list:
    """The fields of the dataclass ``params`` (a DiffParams), in order."""
    return [getattr(params, f.name) for f in dataclasses.fields(params)]


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, params, step: int,
                    extra: Optional[dict] = None) -> None:
    """Save the fields of ``params`` (a dataclass of tensors or arrays) and
    the step counter to ``path`` (.npz), atomically."""
    payload = {f"leaf_{i}": _numpy(x) for i, x in enumerate(_leaves(params))}
    payload["__step__"] = np.int64(step)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = _numpy(v)
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, params_template
                    ) -> Optional[Tuple[Any, int]]:
    """(params, step) restored from ``path`` into a dataclass of the
    template's type, each field a tensor on the device and of the dtype of
    the template's (a numpy array where the template's is one); None if
    there is no file."""
    if not os.path.exists(path):
        return None
    template = _leaves(params_template)
    with np.load(path, allow_pickle=False) as z:
        raw = [z[f"leaf_{i}"] for i in range(len(template))]
        step = int(z["__step__"])
    leaves = [torch.from_numpy(np.array(a)).to(device=t.device, dtype=t.dtype)
              if torch.is_tensor(t) else a for a, t in zip(raw, template)]
    return type(params_template)(*leaves), step
