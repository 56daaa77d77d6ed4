"""The displaced icosphere on the ground box, flat shading (the bench's
scene with the procedural stand-in for the Stanford bunny)."""

from . import procedural as P


def build(config: dict, seed: int) -> P.SceneArrays:
    """The same scene for every seed, so every seed does the same work."""
    return P.sphere_on_ground(int(config["subdivisions"]))
