"""The device's idle share of the profiled stretch: 1 − the union of its
activities' intervals over the stretch (first activity's start to last
activity's end), in percent."""

from benchmark import trace

KIND = "per_layer"
UNIT = "%"


def read(run):
    s = run.stretch
    if s is None or not s.device:
        return None
    busy, first, last = trace.busy_union(s.device)
    return 100.0 * (1.0 - busy / (last - first))
