"""Device tracing + capture telemetry (port of trident_tpu/utils/profiling.py).

The reference's profiling story is a frame-timing ring + CSV capture
sessions (Renderer.cpp:6286-6391); the additions are `torch.profiler`
traces (Chrome trace JSON, viewable in Perfetto) of the host and, on the
card, its CUDA activity, and the count of CUDA graph captures: on the card
a new frame key captures a graph, the counterpart of the JAX package's
retrace, and a growing count between frames is the same kind of hitch.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class CompilationStats:
    """CUDA graph captures made by the live Renderers' frame-graph caches
    (render/graphs.py::FrameGraphs) — a growing count between frames means
    a new frame key was captured (the JAX package's retrace; the field
    keeps its name)."""

    render_frame_variants: int


def compilation_stats() -> CompilationStats:
    from trident_tpu_torch.render.graphs import LIVE

    return CompilationStats(
        render_frame_variants=int(sum(g.captures for g in list(LIVE))))


class Profiler:
    """Start/stop a `torch.profiler` trace (the perf-capture-session
    analogue): CPU activity, and CUDA activity when a card is present.
    `stop()` writes the trace as Chrome JSON under trace_dir and returns
    the file's path."""

    def __init__(self, trace_dir: str = "PerformanceCaptures/traces") -> None:
        self.trace_dir = trace_dir
        self.active = False
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> bool:
        if self.active:
            return True
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True
        return True

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        prof, self._prof = self._prof, None
        self.active = False
        prof.__exit__(None, None, None)
        path = os.path.join(self.trace_dir,
                            f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                            f"{os.getpid()}_{id(prof):x}.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def profile_block(name: str):
    """Annotate a host-side block in the trace (`record_function`). The
    single `yield` sits OUTSIDE any except path: a yield in an except
    handler would make the generator yield twice when the USER'S block
    raises (contextlib throws into the first yield), replacing the real
    exception with RuntimeError(\"generator didn't stop after throw()\")."""
    with torch.profiler.record_function(name):
        yield
