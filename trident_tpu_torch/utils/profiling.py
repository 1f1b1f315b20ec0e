"""Device tracing + capture telemetry (port of trident_tpu/utils/profiling.py).

The reference's profiling story is a frame-timing ring + CSV capture
sessions (Renderer.cpp:6286-6391); the additions are `torch.profiler`
traces (Chrome trace JSON, viewable in Perfetto) of the host and, on the
card, its CUDA activity, and the count of CUDA graph captures: on the card
a new frame key captures a graph, the counterpart of the JAX package's
retrace, and a growing count between frames is the same kind of hitch.

The tracer (`TRACER`, one per process) is the program's own record of
where a frame's host time goes and how often the host waits for the card:

  * spans: host seconds summed and calls counted per name
    (`state`, `state.gather`, `anim.readback`, `submit.replay`, ...), and
    the blocking waits on the card, named `wait.<site>`, alike;
  * counters per name (`idle_cache.hits`, `upload.bytes`, ...);
  * `frames`, ticked once per rendered viewport or replayed row.

It accumulates while tracing is switched on (`tracing(True)`, which
`Profiler.start()` makes) or while any `torch.profiler` session records.
Only when switched on through this module does a span also open a
`record_function` range, `trident.<span>`, so that the operator's Chrome
trace shows the spans on the device's clock. Inside a session it did not
open itself the program emits no range: a range that launches device work
appears on the device timeline too, and a foreign session's readers
would count it as work. Off, a span costs two flag reads and returns a
shared null context; `record_function` is never called.

Stage marks: the frame graph is replayed, so no host range can tell its
kernels apart. `stage_mark(stage, device)` launches a one-thread kernel
(csrc/stage_mark.cu, a `__global__` named `stage_mark_<stage>` per stage)
in every frame, so a profiler trace can split its device records by the
marks' names alone. While tracing is switched on the marks also write
the card's `%globaltimer` into a per-device ring (a switch in the ring,
which `tracing` sets); the `frame` mark advances a device-side counter
that picks the ring's row, so marks captured once work in every replay.
`stage_ms(last=n)` reads the ring back: device milliseconds per stage
over the last n whole frames stamped.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


RANGE_PREFIX = "trident."


class _NullSpan:
    """The span of an inactive tracer: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _Span:
    """Times a block into its tracer; with tracing switched on it is also
    a `record_function` range named trident.<name>."""

    __slots__ = ("tracer", "name", "t0", "range")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self.tracer = tracer
        self.name = name
        self.range = None

    def __enter__(self):
        if self.tracer.on:
            self.range = torch.profiler.record_function(RANGE_PREFIX
                                                        + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        t = self.tracer
        t.seconds[self.name] += dt
        t.calls[self.name] += 1
        return False


class Tracer:
    """Host spans, blocking waits (spans named wait.<site>), counters and
    frames of this process (the module docstring)."""

    def __init__(self) -> None:
        self.on = False
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.frames = 0

    def span(self, name: str):
        """A context manager that times its block as span `name`."""
        if not (self.on or _autograd_profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.on or _autograd_profiler._is_profiler_enabled:
            self.counters[name] += n

    def frame(self) -> None:
        if self.on or _autograd_profiler._is_profiler_enabled:
            self.frames += 1

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean host milliseconds of a call of span `name` (None if it
        never ran)."""
        n = self.calls.get(name, 0)
        return None if not n else 1e3 * self.seconds[name] / n

    def total(self, name: str):
        """A span's summed seconds, or a counter's count (0 if neither
        ran)."""
        if name in self.calls:
            return self.seconds[name]
        return self.counters.get(name, 0)

    def host_wait_ms(self) -> Optional[float]:
        """Milliseconds the host waited on the card (every wait.<site>)
        per frame; None before a frame was counted."""
        if not self.frames:
            return None
        return 1e3 * sum(s for k, s in self.seconds.items()
                         if k.startswith("wait.")) / self.frames

    def reset(self) -> None:
        """Clear spans, counters and frames (tracing stays as it is)."""
        self.seconds.clear()
        self.calls.clear()
        self.counters.clear()
        self.frames = 0

    def snapshot(self) -> dict:
        """A plain dict: frames, spans {name: {"seconds", "calls"}},
        counters, and the live frame graphs' captures and evictions (read
        from them, as compilation_stats reads captures)."""
        from trident_tpu_torch.render.graphs import LIVE

        live = list(LIVE)
        counters = dict(self.counters)
        counters["graph.captures"] = int(sum(g.captures for g in live))
        counters["graph.evictions"] = int(
            sum(getattr(g, "evictions", 0) for g in live))
        return {"frames": self.frames,
                "spans": {k: {"seconds": self.seconds[k],
                              "calls": self.calls[k]} for k in self.calls},
                "counters": counters}


TRACER = Tracer()


def tracing(on: bool = True) -> None:
    """Switch the tracer on (spans accumulate and emit trident.* ranges,
    the stage marks stamp the device's clock) or off (it then accumulates
    only inside a torch.profiler session, and the marks stamp nothing)."""
    TRACER.on = bool(on)
    for ring in _rings.values():
        ring[1] = int(TRACER.on)


# -- device stage marks ----------------------------------------------------

# the frame's stages in order, as the marks name them; a mark is launched
# at the start of its stage, `end` after the frame's last work
STAGES = ("frame", "geometry", "shadow", "binning", "visibility", "resolve",
          "shading", "post", "end")
RING_HEADER = 2           # the frame counter, the stamping switch
RING_FRAMES = 64          # frames the ring keeps (rows)
RING_SLOTS = 16           # stamps per row: one per stage, the frame's
SEQ_SLOT = 15             # sequence number in the last
_rings: Dict[int, torch.Tensor] = {}


def _device_index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def stage_ring(device) -> torch.Tensor:
    """The mark ring of a CUDA device: (RING_HEADER + RING_FRAMES ·
    RING_SLOTS,) int64: the frame counter, the stamping switch (the
    tracer's state), then one row of ns stamps per frame. Allocated on
    first use, outside any graph capture (FrameGraphs makes it when it is
    built), and kept for the process."""
    idx = _device_index(device)
    ring = _rings.get(idx)
    if ring is None:
        ring = torch.zeros(RING_HEADER + RING_FRAMES * RING_SLOTS,
                           dtype=torch.int64, device=torch.device("cuda", idx))
        ring[1] = int(TRACER.on)
        _rings[idx] = ring
    return ring


def stage_mark(stage: str, device) -> None:
    """Stamp the start of `stage` (one of STAGES) of the frame on
    `device`: a one-thread kernel on the current stream. Nothing on the
    CPU; nothing inside a capture on a device whose ring does not exist
    yet (allocating it there would put it in the graph's pool)."""
    if device.type != "cuda":
        return
    idx = _device_index(device)
    ring = _rings.get(idx)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            return
        ring = stage_ring(device)
    from trident_tpu_torch import _build

    _build.launch("trident_stage_mark", [ctypes.c_int, ctypes.c_void_p], idx,
                  STAGES.index(stage), ring.data_ptr())


def stage_rows(ring, last: int) -> list:
    """The stamp rows (RING_SLOTS ints) of the last `last` whole frames of
    a ring read back to the host, newest first: rows whose frame and end
    stamps are both written and whose sequence number is their own."""
    ring = [int(v) for v in ring]
    seq = ring[0]
    rows = []
    for s in range(seq, max(seq - RING_FRAMES, 0), -1):
        if len(rows) >= last:
            break
        o = RING_HEADER + (s % RING_FRAMES) * RING_SLOTS
        row = ring[o:o + RING_SLOTS]
        if row[SEQ_SLOT] == s and row[0] and row[STAGES.index("end")]:
            rows.append(row)
    return rows


def stage_split(rows) -> Dict[str, float]:
    """Mean device milliseconds per stage over stamp rows: a stage runs
    from its mark to the next mark the frame wrote; `frame_total` is the
    frame mark to the end mark."""
    sums: Dict[str, float] = defaultdict(float)
    for row in rows:
        marks = [(row[i], STAGES[i]) for i in range(len(STAGES)) if row[i]]
        for (t0, name), (t1, _n) in zip(marks, marks[1:]):
            sums[name] += (t1 - t0) * 1e-6
        sums["frame_total"] += (row[STAGES.index("end")] - row[0]) * 1e-6
    return {k: v / len(rows) for k, v in sums.items()} if rows else {}


def stage_ms(last: int = 16, device=None) -> Dict[str, float]:
    """Device milliseconds per stage (and `frame_total`) over the last
    `last` whole frames rendered on `device` (the current CUDA device when
    None) while tracing was on: one device-to-host copy of the ring, which
    waits for the work queued on the current stream. {} off the card or
    before such a frame."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    idx = _device_index(device)
    ring = _rings.get(idx)
    if ring is None:
        return {}
    return stage_split(stage_rows(ring.cpu().tolist(), last))


class Profiler:
    """Start/stop a `torch.profiler` trace (the perf-capture-session
    analogue): CPU activity, and CUDA activity when a card is present,
    with the tracer switched on, so that the trace holds the program's
    trident.* spans. `stop()` switches it off and writes the trace as
    Chrome JSON under trace_dir and returns the file's path."""

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
        tracing(True)
        self.active = True
        return True

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        prof, self._prof = self._prof, None
        self.active = False
        tracing(False)
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
