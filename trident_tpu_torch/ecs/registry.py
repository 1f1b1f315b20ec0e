"""Entity/component registry.

Reference: ECS/Registry.h:76-206 — type-erased per-type storages keyed by
entity id, auto-attached UUIDComponent on create, and CopyFrom deep-clone
used for play-mode sandboxing. The Python analogue keeps dict-of-dict
storages; the renderer compiles these into packed draw arrays each frame
(see render/frame.py), so per-entity dict lookups stay on the host.

The port's own copy of trident_tpu/ecs/registry.py: the port imports nothing of
the JAX package. `from_reference` carries a scene built with the JAX
package's registry across to this one (the scene-state counterpart of
render/types.py's `from_numpy`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, List, Optional, Tuple, Type, TypeVar

import numpy as np

from trident_tpu_torch.core.ids import new_uuid
from trident_tpu_torch.ecs import components as C
from trident_tpu_torch.ecs.components import UUIDComponent

Entity = int
T = TypeVar("T")


class Registry:
    def __init__(self) -> None:
        self._next_entity: Entity = 1
        self._alive: List[Entity] = []
        self._storages: Dict[Type, Dict[Entity, object]] = {}

    # -- entities -----------------------------------------------------------
    def create(self) -> Entity:
        entity = self._next_entity
        self._next_entity += 1
        self._alive.append(entity)
        self.add(entity, UUIDComponent(new_uuid()))
        return entity

    def destroy(self, entity: Entity) -> None:
        if entity in self._alive:
            self._alive.remove(entity)
        for storage in self._storages.values():
            storage.pop(entity, None)

    def alive(self) -> List[Entity]:
        return list(self._alive)

    def is_alive(self, entity: Entity) -> bool:
        return entity in self._alive

    def __len__(self) -> int:
        return len(self._alive)

    # -- components ---------------------------------------------------------
    def add(self, entity: Entity, component: T) -> T:
        self._storages.setdefault(type(component), {})[entity] = component
        return component

    def has(self, entity: Entity, component_type: Type[T]) -> bool:
        return entity in self._storages.get(component_type, {})

    def get(self, entity: Entity, component_type: Type[T]) -> T:
        try:
            return self._storages[component_type][entity]  # type: ignore[return-value]
        except KeyError:
            raise KeyError(f"entity {entity} has no {component_type.__name__}") from None

    def try_get(self, entity: Entity, component_type: Type[T]) -> Optional[T]:
        storage = self._storages.get(component_type)
        return None if storage is None else storage.get(entity)  # type: ignore[return-value]

    def remove(self, entity: Entity, component_type: Type[T]) -> None:
        self._storages.get(component_type, {}).pop(entity, None)

    def view(self, *component_types: Type) -> Iterator[Tuple[Entity, tuple]]:
        """Iterate (entity, components...) over entities having ALL types,
        in creation order."""
        storages = [self._storages.get(t, {}) for t in component_types]
        if not storages or not all(storages):
            return                  # a type no entity has: an empty view
        for entity in self._alive:
            for s in storages:
                if entity not in s:
                    break
            else:
                yield entity, tuple(s[entity] for s in storages)

    def single(self, component_type: Type[T]) -> Optional[Tuple[Entity, T]]:
        for entity, (component,) in self.view(component_type):
            return entity, component  # type: ignore[return-value]
        return None

    # -- play-mode sandboxing ------------------------------------------------
    def copy_from(self, other: "Registry") -> None:
        """Deep-clone `other` into self (reference: Registry::CopyFrom,
        Registry.h:115-137). Components are cloned via their .copy()."""
        self._next_entity = other._next_entity
        self._alive = list(other._alive)
        self._storages = {}
        for ctype, storage in other._storages.items():
            self._storages[ctype] = {
                e: (c.copy() if hasattr(c, "copy") else c) for e, c in storage.items()
            }

    def clone(self) -> "Registry":
        out = Registry()
        out.copy_from(self)
        return out


def _carry(value):
    """One component field carried across: numpy arrays copied, enum
    members mapped to the port's enum of the same class name by member
    name, everything else kept as it is."""
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, enum.Enum):
        return getattr(C, type(value).__name__)[value.name]
    return value


def from_reference(registry) -> Registry:
    """The port's Registry holding the same scene as `registry`, a Registry
    of the JAX package (or any object with the same storages): the same
    entity ids in the same creation order, and for every component an
    instance of the port's class of the same name with every dataclass
    field carried across (numpy arrays copied). Classes match by name, so
    the JAX package is never imported."""
    ports = {cls.__name__: cls for cls in C.ALL_COMPONENT_TYPES}
    out = Registry()
    out._next_entity = registry._next_entity
    out._alive = list(registry._alive)
    for ctype, storage in registry._storages.items():
        cls = ports.get(ctype.__name__)
        if cls is None:
            raise TypeError(f"no port component named {ctype.__name__}")
        out._storages[cls] = {
            e: cls(**{f.name: _carry(getattr(c, f.name))
                      for f in dataclasses.fields(c)})
            for e, c in storage.items()}
    return out
