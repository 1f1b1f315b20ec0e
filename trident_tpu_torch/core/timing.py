"""Frame timing: delta clock + 240-sample telemetry ring with CSV export.

Reference: Time (Core/Utilities.h:162-175), the frame-timing ring and
capture sessions (Renderer/Renderer.h:81-96,472-479; Renderer.cpp:6286-6391).

The port's own copy of trident_tpu/core/timing.py: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import csv
import os
import time as _time
from dataclasses import dataclass
from typing import List, Optional, Tuple


class Time:
    """Per-frame delta/FPS clock."""

    def __init__(self) -> None:
        self._last = _time.perf_counter()
        self.delta: float = 0.0
        self.elapsed: float = 0.0
        self.frame_count: int = 0

    def tick(self) -> float:
        now = _time.perf_counter()
        self.delta = now - self._last
        self._last = now
        self.elapsed += self.delta
        self.frame_count += 1
        return self.delta

    @property
    def fps(self) -> float:
        return 1.0 / self.delta if self.delta > 0 else 0.0


@dataclass(frozen=True)
class FrameTimingSample:
    milliseconds: float
    fps: float
    width: int
    height: int
    timestamp: float


@dataclass(frozen=True)
class FrameTimingStats:
    sample_count: int
    min_ms: float
    max_ms: float
    avg_ms: float
    avg_fps: float


class FrameTimingRing:
    """Fixed 240-sample ring with running min/max/avg and optional capture
    sessions that export CSV to a PerformanceCaptures directory."""

    CAPACITY = 240

    def __init__(self, capture_dir: str = "PerformanceCaptures") -> None:
        self._samples: List[FrameTimingSample] = []
        self._next = 0
        self._capture: Optional[List[FrameTimingSample]] = None
        self._capture_dir = capture_dir

    def accumulate(self, ms: float, extent: Tuple[int, int]) -> None:
        fps = 1000.0 / ms if ms > 0 else 0.0
        sample = FrameTimingSample(ms, fps, extent[0], extent[1], _time.time())
        if len(self._samples) < self.CAPACITY:
            self._samples.append(sample)
        else:
            self._samples[self._next] = sample
        self._next = (self._next + 1) % self.CAPACITY
        if self._capture is not None:
            self._capture.append(sample)

    def stats(self) -> FrameTimingStats:
        if not self._samples:
            return FrameTimingStats(0, 0.0, 0.0, 0.0, 0.0)
        ms = [s.milliseconds for s in self._samples]
        avg = sum(ms) / len(ms)
        return FrameTimingStats(
            sample_count=len(ms),
            min_ms=min(ms),
            max_ms=max(ms),
            avg_ms=avg,
            avg_fps=1000.0 / avg if avg > 0 else 0.0,
        )

    # -- capture sessions ---------------------------------------------------
    def begin_capture(self) -> None:
        self._capture = []

    @property
    def capturing(self) -> bool:
        return self._capture is not None

    def end_capture(self) -> Optional[str]:
        """Stop capturing and write capture_YYYYMMDD_HHMMSS.csv; returns path."""
        if self._capture is None:
            return None
        samples, self._capture = self._capture, None
        if not samples:
            return None
        os.makedirs(self._capture_dir, exist_ok=True)
        stamp = _time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self._capture_dir, f"capture_{stamp}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["timestamp", "milliseconds", "fps", "width", "height"])
            for s in samples:
                writer.writerow([f"{s.timestamp:.6f}", f"{s.milliseconds:.4f}",
                                 f"{s.fps:.2f}", s.width, s.height])
        return path
