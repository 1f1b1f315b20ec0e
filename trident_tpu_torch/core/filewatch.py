"""Polled asset hot-reload watcher.

Reference: FileWatcher (Core/Utilities.h:87-158, Utilities.cpp:126+): polls
Assets/{Shaders,Models,Textures} with per-type extension filters, queues
ReloadEvents consumed by the renderer (Renderer.cpp:5739-5820). Here the
"shader" type maps to Python shading modules (kernels are jitted from
source, so reload = cache invalidation handled by the caller).

The port's own copy of trident_tpu/core/filewatch.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from enum import Enum, auto
from typing import Dict, List, Optional, Sequence, Tuple


class ReloadType(Enum):
    TEXTURE = auto()
    MODEL = auto()
    SHADER = auto()


class ReloadStatus(Enum):
    PENDING = auto()
    SUCCESS = auto()
    FAILED = auto()


@dataclass
class ReloadEvent:
    event_id: int
    kind: ReloadType
    path: str
    status: ReloadStatus = ReloadStatus.PENDING


DEFAULT_EXTENSIONS: Dict[ReloadType, Tuple[str, ...]] = {
    ReloadType.TEXTURE: (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".exr", ".ktx", ".ktx2", ".svg"),
    ReloadType.MODEL: (".obj", ".gltf", ".glb", ".fbx", ".dae", ".stl", ".ply"),
    ReloadType.SHADER: (".py",),
}


class FileWatcher:
    """Poll watched directories for mtime changes and queue reload events."""

    def __init__(self, poll_interval: float = 0.5) -> None:
        self._watches: List[Tuple[str, ReloadType, Tuple[str, ...]]] = []
        self._mtimes: Dict[Tuple[str, ReloadType], float] = {}
        self._pending: List[ReloadEvent] = []
        self._next_id = 1
        self._poll_interval = poll_interval
        self._last_poll = 0.0
        self._primed = False

    def watch(self, directory: str, kind: ReloadType,
              extensions: Optional[Sequence[str]] = None) -> None:
        exts = tuple(e.lower() for e in (extensions or DEFAULT_EXTENSIONS[kind]))
        self._watches.append((directory, kind, exts))
        if self._primed:
            # baseline ONLY the new watch: resetting the global prime would
            # make the next poll() swallow real pending changes in every
            # previously-watched directory
            for key, mtime in self._scan_one(directory, kind, exts).items():
                self._mtimes.setdefault(key, mtime)

    def _scan_one(self, directory: str, kind: ReloadType,
                  exts: Tuple[str, ...]) -> Dict[Tuple[str, ReloadType], float]:
        seen: Dict[Tuple[str, ReloadType], float] = {}
        if not os.path.isdir(directory):
            return seen
        for root, _dirs, files in os.walk(directory):
            for name in files:
                if os.path.splitext(name)[1].lower() in exts:
                    path = os.path.join(root, name)
                    try:
                        seen[(path, kind)] = os.stat(path).st_mtime
                    except OSError:
                        continue
        return seen

    def _scan(self) -> Dict[Tuple[str, ReloadType], float]:
        seen: Dict[Tuple[str, ReloadType], float] = {}
        for directory, kind, exts in self._watches:
            seen.update(self._scan_one(directory, kind, exts))
        return seen

    def poll(self, now: Optional[float] = None) -> int:
        """Scan (rate-limited); returns number of newly queued events."""
        now = time.monotonic() if now is None else now
        if now - self._last_poll < self._poll_interval:
            return 0
        self._last_poll = now
        current = self._scan()
        queued = 0
        for (path, kind), mtime in current.items():
            # keyed by (path, kind): a file matched by two watches of
            # different kinds must fire BOTH subsystems' events
            prev = self._mtimes.get((path, kind))
            self._mtimes[(path, kind)] = mtime
            if not self._primed:
                continue  # first scan just records baseline
            if prev is None or mtime != prev:
                # != not >: cp -p / rsync -a / tar -x replace files with
                # PRESERVED (possibly older) timestamps
                self._pending.append(ReloadEvent(self._next_id, kind, path))
                self._next_id += 1
                queued += 1
        self._primed = True
        return queued

    def pop_pending(self) -> Optional[ReloadEvent]:
        return self._pending.pop(0) if self._pending else None

    def pending_count(self) -> int:
        return len(self._pending)
