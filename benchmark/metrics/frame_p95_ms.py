"""The 95th percentile of the intervals between consecutive frame
completions in the window (the first from the window's start mark), each
completion a CUDA event recorded after the frame's last work on the
card: the hitch a user sees."""

import numpy as np

KIND = "end_to_end"
UNIT = "ms"


def intervals(times_ms) -> np.ndarray:
    t = np.asarray(times_ms, np.float64)
    return np.diff(np.concatenate([[0.0], t]))


def read(run):
    return float(np.percentile(intervals(run.window.times_ms), 95))
