"""Logging: python logging with a console ring-buffer sink.

Mirrors the reference's spdlog setup — stdout sink, file sink, and an
in-editor console ring of 2000 entries (Core/Utilities.cpp:18-33,91-114,
ring size at Utilities.cpp:49).

The port's own copy of trident_tpu/core/log.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional


@dataclass(frozen=True)
class ConsoleEntry:
    level: int
    logger: str
    message: str


class ConsoleLog:
    """Bounded ring of recent log entries for UI/console consumers."""

    _lock = threading.Lock()
    _entries: Deque[ConsoleEntry] = deque(maxlen=2000)

    @classmethod
    def push(cls, entry: ConsoleEntry) -> None:
        with cls._lock:
            cls._entries.append(entry)

    @classmethod
    def entries(cls, min_level: int = logging.NOTSET) -> List[ConsoleEntry]:
        with cls._lock:
            return [e for e in cls._entries if e.level >= min_level]

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._entries.clear()


class _ConsoleRingHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        ConsoleLog.push(ConsoleEntry(record.levelno, record.name, record.getMessage()))


_configured = False


def _configure(log_file: Optional[str]) -> None:
    global _configured
    root = logging.getLogger("trident")
    if _configured:
        return
    root.setLevel(logging.DEBUG)
    fmt = logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
    stream = logging.StreamHandler()
    stream.setFormatter(fmt)
    stream.setLevel(logging.INFO)
    root.addHandler(stream)
    root.addHandler(_ConsoleRingHandler())
    if log_file:
        try:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            root.addHandler(fh)
        except OSError:
            pass
    root.propagate = False
    _configured = True


def get_logger(name: str = "core", log_file: Optional[str] = "trident_tpu.log") -> logging.Logger:
    _configure(log_file)
    return logging.getLogger(f"trident.{name}")
