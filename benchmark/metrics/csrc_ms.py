"""The hand-written kernels (csrc/*.cu): their device milliseconds per
frame in the profiled stretch."""

from benchmark import trace

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    s = run.stretch
    if s is None:
        return None
    us = sum(r.end_us - r.start_us for r in s.device
             if trace.kernel_of(r.name) is not None)
    return us / 1e3 / s.frames if us else None
