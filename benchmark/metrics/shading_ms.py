"""The shading stage (texture sampling, shadow taps, PBR or a custom
shader, the background): device milliseconds per frame of the profiled
stretch's records between each frame's `stage_mark_shading` and its next
mark (benchmark/stages.py). Nothing to read without the program's
marks."""

from benchmark import stages

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return stages.stage_ms(run.stretch, "shading")
