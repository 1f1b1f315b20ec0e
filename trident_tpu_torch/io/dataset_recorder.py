"""Frame dataset recorder: NPY pairs + JSON metadata on a writer thread.

Port of trident_tpu/io/dataset_recorder.py, a copy with its imports
renamed: it writes the same .npy and .json bytes.

Reference: AI/FrameDatasetRecorder.{h,cpp} — background thread pairs input
frames with AI outputs by monotonic index, writes NPY v1.0 files + JSON
metadata (extent/channels/shape/color order/normalized), with a sampling
interval and capture-directory management. numpy's .npy IS that format.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from trident_tpu_torch.core.log import get_logger

logger = get_logger("io.dataset")


@dataclass
class _Job:
    kind: str          # "input" | "output"
    index: int
    frame: np.ndarray  # (H,W,3) float32 [0,1]


class FrameDatasetRecorder:
    def __init__(self, directory: str = "DatasetCaptures",
                 interval_s: float = 0.5) -> None:
        self.directory = directory
        self.interval_s = interval_s
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=64)
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._next_index = 0
        self._last_capture = float("-inf")
        self.written_count = 0

    # -- session ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        os.makedirs(self.directory, exist_ok=True)
        self._running = True
        self._worker = threading.Thread(target=self._loop, name="dataset-writer",
                                        daemon=True)
        self._worker.start()
        logger.info("dataset capture started → %s", self.directory)

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self._queue.put(None)
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        logger.info("dataset capture stopped (%d files)", self.written_count)

    @property
    def running(self) -> bool:
        return self._running

    # -- capture -------------------------------------------------------------------
    def record_input_frame(self, frame: np.ndarray,
                           now: Optional[float] = None) -> Optional[int]:
        """Throttled by interval; returns the sample index if captured."""
        if not self._running:
            return None
        now = time.monotonic() if now is None else now
        if now - self._last_capture < self.interval_s:
            return None
        try:
            self._queue.put_nowait(_Job("input", self._next_index,
                                        np.asarray(frame, np.float32)))
        except queue.Full:
            # enqueue failed: do NOT consume the index (the dataset stays
            # gap-free) and do NOT burn the throttle window (retry on the
            # very next frame instead of interval_s later)
            return None
        self._last_capture = now
        index = self._next_index
        self._next_index += 1
        return index

    def record_ai_output(self, index: int, frame: np.ndarray) -> None:
        if not self._running:
            return
        try:
            self._queue.put_nowait(_Job("output", index, np.asarray(frame, np.float32)))
        except queue.Full:
            pass

    # -- worker --------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                break
            try:
                self._write(job)
            except Exception as exc:
                logger.warning("dataset write failed: %s", exc)

    def _write(self, job: _Job) -> None:
        name = f"frame_{job.index:06d}_{job.kind}"
        path = os.path.join(self.directory, name + ".npy")
        np.save(path, job.frame)
        meta = {
            "index": job.index,
            "kind": job.kind,
            "width": int(job.frame.shape[1]),
            "height": int(job.frame.shape[0]),
            "channels": int(job.frame.shape[2]) if job.frame.ndim == 3 else 1,
            "shape": list(job.frame.shape),
            "color_order": "rgb",
            "normalized": True,
            "dtype": str(job.frame.dtype),
        }
        with open(os.path.join(self.directory, name + ".json"), "w") as f:
            json.dump(meta, f)
        self.written_count += 1
