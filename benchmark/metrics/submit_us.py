"""Frame loop: the mean host microseconds of a FrameGraphs.run or
run_rows call (staging, the graph's launch, the output clones) in a
traced run's window."""

KIND = "per_layer"
UNIT = "us/frame"


def read(run):
    ms = run.spans.mean_ms("submit")
    return None if ms is None else 1e3 * ms
