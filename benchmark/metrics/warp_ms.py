"""The upscaled frame's warp stage (the previous history reprojected into
this view and fetched by the warp kernel): device milliseconds per frame
of the profiled stretch's records between each frame's `stage_mark_warp`
and its next mark (benchmark/stages.py). Nothing to read without the
program's warp mark."""

from benchmark import stages

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return stages.stage_ms(run.stretch, "warp")
