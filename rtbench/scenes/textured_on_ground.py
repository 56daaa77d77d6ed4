"""The displaced icosphere with vertex normals on the checker-textured
ground box."""

from . import procedural as P


def build(config: dict, seed: int) -> P.SceneArrays:
    """The same scene for every seed, so every seed does the same work."""
    return P.textured_on_ground(int(config["subdivisions"]))
