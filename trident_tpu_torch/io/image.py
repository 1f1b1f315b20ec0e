"""Procedural textures.

The port's own copy of `checkerboard` from trident_tpu/io/image.py (the
PIL-backed loaders stay in the JAX package): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


def checkerboard(size: int = 64, cells: int = 8,
                 color_a=(255, 255, 255, 255), color_b=(40, 40, 40, 255)) -> np.ndarray:
    """Procedural test texture."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell) + (y // cell)) % 2 == 0
    out = np.where(mask[..., None], np.array(color_a, np.uint8), np.array(color_b, np.uint8))
    return out.astype(np.uint8)
