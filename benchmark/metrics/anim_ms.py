"""Animation: the mean host milliseconds of a Scene.update call (the
animation system's clip sampling and palettes) in a traced run's
window."""

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return run.spans.mean_ms("anim")
