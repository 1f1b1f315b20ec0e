"""The upscaled frame's upscale stage (the net's four convs over the base,
the history's bytes, depth-to-space and the display frame's bytes):
device milliseconds per frame of the profiled stretch's records between
each frame's `stage_mark_upscale` and its `end` mark
(benchmark/stages.py). Nothing to read without the program's upscale
mark."""

from benchmark import stages

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return stages.stage_ms(run.stretch, "upscale")
