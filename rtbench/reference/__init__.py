"""The benchmark's plain reference (``render.py``): plain PyTorch and
numpy, importing nothing of the program under test."""
