"""The turntable driver (driver/animation.py)."""
