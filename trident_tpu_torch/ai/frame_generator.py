"""FrameGenerator: asynchronous frame-interpolation inference.

Port of trident_tpu/ai/frame_generator.py (the reference's
AI/FrameGenerator.{h,cpp}): a background worker with a bounded job queue;
`process_frame` pairs each submitted frame with the previous one and
enqueues the pair without blocking (dropping it when the queue is full),
and `try_consume_output` polls for a finished middle frame, keeping
per-run latency and a running average (AiDebugStats).

The net (ai/model.py::InterpolationUNet) runs on the generator's device.
On the card the worker enqueues its copies and the forward pass on a
stream of its own and waits on an event recorded after them, so that it
never synchronizes the device or stalls the render stream.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai.model import InterpolationUNet, load_frame_generator
from trident_tpu_torch.ai.train import load_checkpoint
from trident_tpu_torch.core.log import get_logger

logger = get_logger("ai.framegen")


@dataclass
class AiDebugStats:
    """Telemetry surfaced to the AIDebugPanel analogue (Renderer.h:99-110)."""

    queue_depth: int = 0
    completed_count: int = 0
    last_inference_ms: float = 0.0
    average_inference_ms: float = 0.0
    enabled: bool = False


class FrameGenerator:
    def __init__(self, net: Optional[InterpolationUNet] = None,
                 resolution: Tuple[int, int] = (256, 256),
                 queue_limit: int = 2, device=None) -> None:
        self.resolution = resolution
        self.device = resolve_device(device)
        self._net = net
        self._jobs: "queue.Queue[Optional[Tuple[int, np.ndarray, np.ndarray]]]" = \
            queue.Queue(maxsize=queue_limit)
        self._done: "queue.Queue[Tuple[int, np.ndarray, float]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._prev_frame: Optional[np.ndarray] = None
        self._next_index = 0
        self._total_ms = 0.0
        self.stats = AiDebugStats()

    # -- lifecycle -----------------------------------------------------------------
    def initialise(self, path=None,
                   net: Optional[InterpolationUNet] = None) -> bool:
        """Load the weights or adopt an in-memory net, and start the
        worker. `path` is a checkpoint directory that ai/train.py wrote
        (resolved through its latest.json, ai/train.py::load_checkpoint,
        as the JAX generator restores its orbax directory) or the .npz
        export (ai/model.py::load_frame_generator); anything that cannot be
        loaded raises. False when there is no net to run."""
        if net is not None:
            self._net = net
        elif path is not None and os.path.isfile(
                os.path.join(path, "latest.json")):
            self._net = load_checkpoint(path, device=self.device)
        elif path is not None:
            self._net, _bc = load_frame_generator(path, self.device)
        if self._net is None:
            return False
        self._net = self._net.eval().to(self.device)
        # a previous shutdown() can leave its None sentinel (and stale
        # jobs) in the queue when the old worker exited via the _running
        # check instead of consuming it — a fresh worker would dequeue
        # the stale sentinel first and die silently
        while True:
            try:
                self._jobs.get_nowait()
            except queue.Empty:
                break
        self._running = True
        self._worker = threading.Thread(target=self._loop, name="ai-inference",
                                        daemon=True)
        self._worker.start()
        self.stats.enabled = True
        logger.info("frame generator initialised at %sx%s", *self.resolution)
        return True

    def shutdown(self) -> None:
        if not self._running:
            return
        self._running = False
        try:
            self._jobs.put_nowait(None)
        except queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.stats.enabled = False

    # -- API (reference: ProcessFrame / TryConsumeOutput) ----------------------------
    def process_frame(self, frame: np.ndarray) -> Optional[int]:
        """Submit the latest rendered frame (H,W,3 float [0,1]). Pairs it
        with the previous submission; non-blocking (drops when busy).
        Returns the job index if enqueued."""
        if not self._running:
            return None
        frame = np.asarray(frame, np.float32)
        prev, self._prev_frame = self._prev_frame, frame
        if prev is None or prev.shape != frame.shape:
            return None
        index = self._next_index
        try:
            self._jobs.put_nowait((index, prev, frame))
        except queue.Full:
            return None
        self._next_index += 1
        self.stats.queue_depth = self._jobs.qsize()
        return index

    def try_consume_output(self) -> Optional[Tuple[int, np.ndarray]]:
        """Poll for a finished interpolation (index, (H,W,3) float)."""
        try:
            index, frame, ms = self._done.get_nowait()
        except queue.Empty:
            return None
        self.stats.completed_count += 1
        self.stats.last_inference_ms = ms
        self._total_ms += ms
        self.stats.average_inference_ms = self._total_ms / self.stats.completed_count
        self.stats.queue_depth = self._jobs.qsize()
        return index, frame

    # -- worker ---------------------------------------------------------------------
    def _resize(self, frame: np.ndarray) -> np.ndarray:
        h, w = self.resolution
        if frame.shape[:2] == (h, w):
            return frame
        # BILINEAR, matching the training data pipeline (ai/dataset.py
        # resizes with PIL BILINEAR): nearest-neighbor decimation at
        # inference feeds the net an aliased input distribution its
        # PSNR-selected weights never saw
        sh, sw = frame.shape[0], frame.shape[1]
        yf = (np.arange(h) + 0.5) * sh / h - 0.5
        xf = (np.arange(w) + 0.5) * sw / w - 0.5
        y0 = np.clip(np.floor(yf).astype(np.int64), 0, sh - 1)
        x0 = np.clip(np.floor(xf).astype(np.int64), 0, sw - 1)
        y1 = np.minimum(y0 + 1, sh - 1)
        x1 = np.minimum(x0 + 1, sw - 1)
        wy = np.clip(yf - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
        wx = np.clip(xf - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
        top = frame[y0][:, x0] * (1 - wx) + frame[y0][:, x1] * wx
        bot = frame[y1][:, x0] * (1 - wx) + frame[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy

    def _infer(self, pair: np.ndarray, stream) -> np.ndarray:
        """(H, W, 6) pair → (H, W, 3) middle frame. On the card: a pinned
        upload, the net and a pinned readback enqueued on `stream`, then a
        wait on the event recorded after them."""
        x = torch.from_numpy(np.ascontiguousarray(pair)).permute(2, 0, 1)[None]
        with torch.inference_mode():
            if stream is None:
                return self._net(x)[0].permute(1, 2, 0).numpy()
            x_host = x.contiguous().pin_memory()
            with torch.cuda.stream(stream):
                y = self._net(x_host.to(self.device, non_blocking=True))
                y_host = torch.empty(y.shape[2:] + (3,), dtype=torch.float32,
                                     pin_memory=True)
                y_host.copy_(y[0].permute(1, 2, 0), non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            return y_host.numpy()

    def _loop(self) -> None:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        while self._running:
            job = self._jobs.get()
            if job is None:
                break
            index, prev, cur = job
            t0 = time.perf_counter()
            try:
                out = self._infer(np.concatenate(
                    [self._resize(prev), self._resize(cur)], axis=-1), stream)
                ms = (time.perf_counter() - t0) * 1000.0
                self._done.put((index, out, ms))
            except Exception:
                # the worker outlives a failed job, as the reference's does
                logger.exception("inference failed")
