"""`frame_p95_ms` of a draw loop whose pace the host's speed sets, read
per layer (see host_paced_frame_ms). Read from a traced run's window."""

from benchmark.metrics import frame_p95_ms

KIND = "per_layer"
UNIT = "ms"


def read(run):
    return frame_p95_ms.read(run)
