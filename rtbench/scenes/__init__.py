"""Scene builders of the benchmark's configurations.

``<name>.py`` builds the scene a configuration file names under "scene":
``build(config, seed) -> procedural.SceneArrays``.  A builder may draw
from the seed only what leaves the work the same.  ``port.py`` hands a
scene to the program under test.
"""
