from .render import differentiable_hits, render_radiance_diff

__all__ = ["differentiable_hits", "render_radiance_diff"]
