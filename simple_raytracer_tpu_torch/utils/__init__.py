"""Small helpers shared by the renderers (JAX ``utils/vma.py::pad_rays``;
its ``match_vma`` is a shard_map workaround with no counterpart here)."""

from __future__ import annotations

import torch


def pad_rays(o: torch.Tensor, d: torch.Tensor, multiple: int):
    """Pad the flat ray axis [R, 3] to a multiple of ``multiple`` by
    repeating the last ray (harmless duplicate work).  Returns (o, d, R)."""
    R = o.shape[0]
    pad = (-R) % multiple
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)], dim=0)
        d = torch.cat([d, d[-1:].expand(pad, 3)], dim=0)
    return o, d, R


__all__ = ["pad_rays"]
