"""Mean frame time: the whole window's milliseconds (from its start mark
to the last frame's completion) over the frames completed in it."""

KIND = "end_to_end"
UNIT = "ms"


def read(run):
    return run.window.times_ms[-1] / run.window.frames
