"""The distribution layer (JAX ``dist/``): process meshes and data-parallel
rendering (``sharding.py``), the geometry-sharded ring (``ring.py``), the
process group's setup (``multihost.py``), training on one card or over a
mesh (``train.py``) and the multi-process dry run (``dryrun.py``)."""

from .sharding import Mesh, make_mesh, render_radiance_sharded, render_sharded
from .ring import ring_nearest_hit, render_flat_ring
from .train import (DiffParams, ReplicatedParams, apply_params,
                    extract_params, make_train_step, make_train_step_composed,
                    params_from_jax)

__all__ = [
    "Mesh", "make_mesh", "render_sharded", "render_radiance_sharded",
    "ring_nearest_hit", "render_flat_ring",
    "DiffParams", "ReplicatedParams", "make_train_step",
    "make_train_step_composed", "extract_params", "apply_params",
    "params_from_jax",
]
