"""Allocation / memory telemetry (port of trident_tpu/core/alloc.py).

Reference: the global operator-new override counting per-frame heap
allocations (Core/Utilities.h:230-235, read each frame at
Renderer.cpp:739,829). Tracked per frame: host-side Python allocations
(tracemalloc) and the card's memory in use (the caching allocator's
`torch.cuda.memory_stats`).
"""

from __future__ import annotations

import tracemalloc
from dataclasses import dataclass

import torch

from trident_tpu_torch import resolve_device


@dataclass
class FrameAllocStats:
    host_allocs: int = 0          # python allocations this frame
    host_bytes: int = 0           # net host bytes this frame
    device_bytes_in_use: int = 0  # card memory allocated (0 on the CPU)
    device_peak_bytes: int = 0


class AllocationTracker:
    """begin_frame/end_frame pair per frame; stats() reads the last frame.
    Host tracking costs ~5% — off by default, enable for debugging like the
    reference's debug-build counter. The device numbers are `device`'s
    (the card unless given; 0 for the CPU)."""

    def __init__(self, track_host: bool = False, device=None) -> None:
        self.track_host = track_host
        self.device = resolve_device(device)
        self._stats = FrameAllocStats()
        self._frame_start = (0, 0)
        self._started = False

    def begin_frame(self) -> None:
        if self.track_host:
            if not tracemalloc.is_tracing():
                tracemalloc.start()
            current, _peak = tracemalloc.get_traced_memory()
            counts = tracemalloc.get_tracemalloc_memory()
            self._frame_start = (current, counts)
        self._started = True

    def end_frame(self) -> None:
        if not self._started:
            return
        self._started = False
        if self.track_host and tracemalloc.is_tracing():
            current, _peak = tracemalloc.get_traced_memory()
            self._stats.host_bytes = current - self._frame_start[0]
            stats = tracemalloc.take_snapshot().statistics("filename")
            self._stats.host_allocs = sum(s.count for s in stats)
        self._stats.device_bytes_in_use, self._stats.device_peak_bytes = \
            device_memory_stats(self.device)

    def stats(self) -> FrameAllocStats:
        return self._stats


def device_memory_stats(device=None) -> tuple:
    """(bytes_in_use, peak_bytes) of `device` (the card unless given): the
    caching allocator's allocated_bytes.all.current and .peak; (0, 0) for
    the CPU, as the JAX function returns for a device that hides them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0, 0
    stats = torch.cuda.memory_stats(dev)
    return (int(stats.get("allocated_bytes.all.current", 0)),
            int(stats.get("allocated_bytes.all.peak", 0)))
