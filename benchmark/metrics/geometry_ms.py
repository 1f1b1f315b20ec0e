"""The geometry stage (the corner stage, or the indexed vertex stage with
its skinning; the triangle setup and the resolve records): device
milliseconds per frame of the profiled stretch's records between each
frame's `stage_mark_geometry` and its next mark (benchmark/stages.py).
Nothing to read without the program's marks."""

from benchmark import stages

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return stages.stage_ms(run.stretch, "geometry")
