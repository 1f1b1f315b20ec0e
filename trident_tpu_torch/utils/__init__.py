"""Utility surface: timing, logging, allocation telemetry, profiling."""

from trident_tpu_torch.core.alloc import AllocationTracker, device_memory_stats
from trident_tpu_torch.core.log import ConsoleLog, get_logger
from trident_tpu_torch.core.timing import FrameTimingRing, FrameTimingStats, Time
from trident_tpu_torch.utils.profiling import (
    Profiler,
    compilation_stats,
    profile_block,
)

__all__ = [
    "AllocationTracker", "device_memory_stats", "ConsoleLog", "get_logger",
    "FrameTimingRing", "FrameTimingStats", "Time",
    "Profiler", "compilation_stats", "profile_block",
]
