"""Video export: ffmpeg H.264 when available, Y4M raw fallback.

Reference: Renderer/VideoEncoder.{h,cpp} — worker thread + frame queue;
libav H.264 path with a Y4M raw container fallback; RGBA→YUV conversion;
begin/submit/end session API. Here ffmpeg runs as a subprocess fed rawvideo
over stdin; without ffmpeg we write Y4M (4:2:0) directly.
`frames_dropped` counts the frames a full queue turned away (the JAX
encoder drops them without counting).

The port's own copy of trident_tpu/io/video.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from trident_tpu_torch.core.log import get_logger

logger = get_logger("io.video")


def rgb_to_yuv420(rgb: np.ndarray):
    """BT.601 full-range RGB→YUV 4:2:0 planes (Y, U, V)."""
    rgb = rgb.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def sub(p):
        h2, w2 = p.shape[0] // 2 * 2, p.shape[1] // 2 * 2
        p = p[:h2, :w2]
        return (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]) * 0.25

    clip = lambda p: np.clip(np.round(p), 0, 255).astype(np.uint8)
    return clip(y), clip(sub(u)), clip(sub(v))


class VideoEncoder:
    """Session-based recorder. Frames must have even dimensions (YUV 4:2:0,
    like the reference's extent sanitation in GameViewportPanel)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=16)
        self._active = False
        self._path = ""
        self._fps = 30
        self._size = (0, 0)
        self._ffmpeg: Optional[subprocess.Popen] = None
        self._y4m = None
        self.frames_submitted = 0
        self.frames_encoded = 0
        self.frames_dropped = 0

    @property
    def active(self) -> bool:
        return self._active

    def begin_session(self, path: str, width: int, height: int, fps: int = 30,
                      prefer_ffmpeg: bool = True) -> bool:
        if self._active:
            return False
        width -= width % 2
        height -= height % 2
        if width <= 0 or height <= 0:
            return False
        self._size = (width, height)
        self._fps = fps
        self._path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)

        ffmpeg = shutil.which("ffmpeg") if prefer_ffmpeg else None
        if ffmpeg and path.lower().endswith((".mp4", ".mkv", ".mov")):
            self._ffmpeg = subprocess.Popen(
                [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                 "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
                 "-c:v", "libx264", "-preset", "fast", "-pix_fmt", "yuv420p",
                 path],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            logger.info("recording via ffmpeg → %s (%dx%d@%d)", path, width, height, fps)
        else:
            if not path.lower().endswith(".y4m"):
                self._path = path = os.path.splitext(path)[0] + ".y4m"
            self._y4m = open(path, "wb")
            self._y4m.write(
                f"YUV4MPEG2 W{width} H{height} F{fps}:1 Ip A1:1 C420\n".encode())
            logger.info("recording Y4M fallback → %s", path)

        self._active = True
        self.frames_submitted = 0
        self.frames_encoded = 0
        self.frames_dropped = 0
        self._thread = threading.Thread(target=self._loop, name="video-encoder",
                                        daemon=True)
        self._thread.start()
        return True

    def submit_frame(self, rgb: np.ndarray) -> bool:
        """rgb: (H,W,3|4) uint8. Non-blocking; drops when the queue is full
        (the reference's drift-recovery analogue)."""
        if not self._active:
            return False
        w, h = self._size
        frame = np.asarray(rgb)[..., :3]
        if frame.shape[0] < h or frame.shape[1] < w:
            return False
        frame = frame[:h, :w]
        try:
            self._queue.put_nowait(frame)
            self.frames_submitted += 1
            return True
        except queue.Full:
            self.frames_dropped += 1
            return False

    def end_session(self) -> Optional[str]:
        if not self._active:
            return None
        self._active = False
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                # the drain is stuck (slow disk / wedged ffmpeg): closing
                # stdin under the writer would race it — log and fall
                # through to a hard finalize; the daemon thread dies with
                # the process
                logger.warning("video encoder still draining after 10s; "
                               "forcing session close")
        if self._ffmpeg is not None:
            # finalize must never leak the process or leave _ffmpeg set: a
            # raised TimeoutExpired here would make the NEXT begin_session
            # leak a zombie encoder
            try:
                self._ffmpeg.stdin.close()
            except Exception:
                pass
            try:
                self._ffmpeg.wait(timeout=30)
            except Exception:
                logger.warning("ffmpeg did not finalize in 30s; killing it "
                               "(the file may be truncated)")
                self._ffmpeg.kill()
                self._ffmpeg.wait()
            self._ffmpeg = None
        if self._y4m is not None:
            self._y4m.close()
            self._y4m = None
        logger.info("recording finished: %s (%d frames)", self._path, self.frames_encoded)
        return self._path

    def _loop(self) -> None:
        while True:
            frame = self._queue.get()
            if frame is None:
                break
            try:
                if self._ffmpeg is not None:
                    self._ffmpeg.stdin.write(np.ascontiguousarray(frame).tobytes())
                elif self._y4m is not None:
                    y, u, v = rgb_to_yuv420(frame)
                    self._y4m.write(b"FRAME\n")
                    self._y4m.write(y.tobytes())
                    self._y4m.write(u.tobytes())
                    self._y4m.write(v.tobytes())
                self.frames_encoded += 1
            except Exception as exc:
                logger.warning("video frame dropped: %s", exc)
