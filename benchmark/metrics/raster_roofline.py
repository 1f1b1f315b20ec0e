"""The share of its roofline that the frame's visibility and resolve
work reaches: the least time of that work (benchmark/work.py, counted
from the frame's own sizes) over the busy time of every kernel that does
it (benchmark/trace.py RASTER_KERNELS), per frame, in percent."""

from benchmark import trace

KIND = "per_layer"
UNIT = "%"


def read(run):
    s, w = run.stretch, run.work
    if s is None or w is None:
        return None
    us = sum(r.end_us - r.start_us for r in s.device
             if trace.kernel_of(r.name) in trace.RASTER_KERNELS)
    if not us:
        return None
    return 100.0 * w.least_ms() / (us / 1e3 / s.frames)
