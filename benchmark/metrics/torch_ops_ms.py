"""The plain-PyTorch stages: device milliseconds per frame, in the
profiled stretch, of every device activity that is not a hand-written
kernel (kernels, copies and fills alike)."""

from benchmark import trace

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    s = run.stretch
    if s is None:
        return None
    us = sum(r.end_us - r.start_us for r in s.device
             if trace.kernel_of(r.name) is None)
    return us / 1e3 / s.frames
