"""`frame_ms` of a draw loop whose pace the host's speed sets, read per
layer: the host frame state is the slower side there, and the shared
host's speed swings too widely between runs for an end-to-end bound
(PERF.md §2). Read from a traced run's window."""

from benchmark.metrics import frame_ms

KIND = "per_layer"
UNIT = "ms"


def read(run):
    return frame_ms.read(run)
