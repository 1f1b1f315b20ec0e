"""Set-up: from the process's start to the first timed frame (imports,
the kernel library, the scene, the traffic, packing and warm-up)."""

KIND = "end_to_end"
UNIT = "s"


def read(run):
    return run.setup_s
