"""Random 64-bit UUIDs (reference: Core/Utilities.cpp:36-42).

The port's own copy of trident_tpu/core/ids.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import secrets


def new_uuid() -> int:
    """Random non-zero 64-bit id."""
    value = 0
    while value == 0:
        value = secrets.randbits(64)
    return value
