"""Event hierarchy + dispatcher (reference: Events/Events.h:10-81,
ApplicationEvents.h / KeyEvents.h / MouseEvents.h).

The headless engine emits these for window/asset/runtime happenings; a UI
frontend can subscribe the same way the editor layer does in the reference.

The port's own copy of trident_tpu/core/events.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Callable, Dict, List, Type


class EventType(Enum):
    WINDOW_RESIZE = auto()
    WINDOW_CLOSE = auto()
    FILE_DROP = auto()
    KEY_PRESSED = auto()
    KEY_RELEASED = auto()
    KEY_TYPED = auto()
    MOUSE_MOVED = auto()
    MOUSE_SCROLLED = auto()
    MOUSE_BUTTON_PRESSED = auto()
    MOUSE_BUTTON_RELEASED = auto()
    ASSET_RELOADED = auto()


@dataclass
class Event:
    handled: bool = field(default=False, init=False)

    @property
    def type(self) -> EventType:
        raise NotImplementedError


@dataclass
class WindowResizeEvent(Event):
    width: int = 0
    height: int = 0

    @property
    def type(self) -> EventType:
        return EventType.WINDOW_RESIZE


@dataclass
class WindowCloseEvent(Event):
    @property
    def type(self) -> EventType:
        return EventType.WINDOW_CLOSE


@dataclass
class FileDropEvent(Event):
    paths: List[str] = field(default_factory=list)

    @property
    def type(self) -> EventType:
        return EventType.FILE_DROP


@dataclass
class KeyEvent(Event):
    key: int = 0
    repeat: bool = False


@dataclass
class KeyPressedEvent(KeyEvent):
    @property
    def type(self) -> EventType:
        return EventType.KEY_PRESSED


@dataclass
class KeyReleasedEvent(KeyEvent):
    @property
    def type(self) -> EventType:
        return EventType.KEY_RELEASED


@dataclass
class MouseMovedEvent(Event):
    x: float = 0.0
    y: float = 0.0

    @property
    def type(self) -> EventType:
        return EventType.MOUSE_MOVED


@dataclass
class MouseScrolledEvent(Event):
    dx: float = 0.0
    dy: float = 0.0

    @property
    def type(self) -> EventType:
        return EventType.MOUSE_SCROLLED


@dataclass
class MouseButtonEvent(Event):
    button: int = 0


@dataclass
class MouseButtonPressedEvent(MouseButtonEvent):
    @property
    def type(self) -> EventType:
        return EventType.MOUSE_BUTTON_PRESSED


@dataclass
class MouseButtonReleasedEvent(MouseButtonEvent):
    @property
    def type(self) -> EventType:
        return EventType.MOUSE_BUTTON_RELEASED


@dataclass
class AssetReloadedEvent(Event):
    path: str = ""
    kind: str = ""  # "texture" | "model" | "shader"

    @property
    def type(self) -> EventType:
        return EventType.ASSET_RELOADED


class EventDispatcher:
    """Route an event to the handler registered for its concrete class.
    A handler returning True marks the event handled (stops propagation)."""

    def __init__(self) -> None:
        self._handlers: Dict[Type[Event], List[Callable[[Event], bool]]] = {}

    def subscribe(self, event_cls: Type[Event], handler: Callable[[Event], bool]) -> None:
        self._handlers.setdefault(event_cls, []).append(handler)

    def dispatch(self, event: Event) -> bool:
        for handler in self._handlers.get(type(event), []):
            if event.handled:
                break
            if handler(event):
                event.handled = True
        return event.handled
