"""Image output (io/image.py)."""
