"""Multi-device rendering: the banded frame (framebuffer.py)."""
