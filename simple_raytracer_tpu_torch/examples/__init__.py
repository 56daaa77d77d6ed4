"""Runnable examples of the port (``python -m simple_raytracer_tpu_torch.examples.NAME``)."""
