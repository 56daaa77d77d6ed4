"""pytest settings for the benchmark's own tests (``rtbench/tests``):
the marker of tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")
