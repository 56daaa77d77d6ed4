"""Training on one card (``train.py``).  JAX's sharded rendering, the ring
renderer and the composed and data-parallel training steps wait for the
port's distribution layer (ROADMAP.md, Open items §1: Distribution)."""

from .train import (DiffParams, apply_params, extract_params,
                    make_train_step, params_from_jax)

__all__ = ["DiffParams", "apply_params", "extract_params",
           "make_train_step", "params_from_jax"]
