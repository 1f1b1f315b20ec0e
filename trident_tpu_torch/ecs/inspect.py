"""Inspector-equivalent component editing: validated get/set/serialize for
every ECS component field.

The reference's InspectorPanel mutates any component field at runtime
through ImGui widgets (Trident-Forge/src/Panels/InspectorPanel.cpp); this
is the headless surface a frontend (or RPC layer) drives instead: typed
field schemas, name-based lookup, coercing setters that validate shape and
enum values, and a dict round-trip that Scene save/load-style tooling can
rely on. Opaque runtime caches (pose matrices, state-machine instances)
are reported but not editable.

The port's own copy of trident_tpu/ecs/inspect.py, over the port's
ecs/components.py.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Dict, List, Optional, Type

import numpy as np

from trident_tpu_torch.ecs import components as C

# name → type, accepting "Transform", "TransformComponent", "transform"
_BY_NAME: Dict[str, type] = {}
for _t in C.ALL_COMPONENT_TYPES:
    short = _t.__name__.removesuffix("Component")
    for key in (_t.__name__, short):
        _BY_NAME[key.lower()] = _t

# fields that are runtime caches, not editable state
_OPAQUE = {"bone_matrices", "state_machine"}


def component_type(name) -> type:
    if isinstance(name, type):
        return name
    t = _BY_NAME.get(str(name).lower())
    if t is None:
        raise KeyError(f"unknown component {name!r}; have "
                       f"{sorted({x.__name__ for x in C.ALL_COMPONENT_TYPES})}")
    return t


def component_schema(comp) -> Dict[str, Dict[str, Any]]:
    """Field schema: {field: {kind, default, [shape]/[choices], editable}}."""
    t = component_type(comp if isinstance(comp, (str, type)) else type(comp))
    proto = t()
    schema: Dict[str, Dict[str, Any]] = {}
    for f in dataclasses.fields(t):
        v = getattr(proto, f.name)
        entry: Dict[str, Any] = {"editable": f.name not in _OPAQUE}
        if isinstance(v, np.ndarray):
            entry.update(kind="vector", shape=tuple(v.shape),
                         default=v.tolist())
        elif isinstance(v, Enum):
            entry.update(kind="enum", choices=[e.name for e in type(v)],
                         default=v.name)
        elif isinstance(v, bool):
            entry.update(kind="bool", default=v)
        elif isinstance(v, int):
            entry.update(kind="int", default=v)
        elif isinstance(v, float):
            entry.update(kind="float", default=v)
        elif isinstance(v, str):
            entry.update(kind="str", default=v)
        else:
            entry.update(kind="opaque", default=None, editable=False)
        schema[f.name] = entry
    return schema


def _coerce(comp, name: str, value):
    """Validate + coerce `value` for field `name`, matching the current
    field's type/shape/enum. Raises ValueError/KeyError on mismatch."""
    if name in _OPAQUE:
        raise ValueError(f"{type(comp).__name__}.{name} is a runtime cache, "
                         "not editable")
    if not any(f.name == name for f in dataclasses.fields(comp)):
        raise KeyError(f"{type(comp).__name__} has no field {name!r}")
    cur = getattr(comp, name)
    if isinstance(cur, np.ndarray):
        arr = np.asarray(value, dtype=cur.dtype)
        if arr.shape != cur.shape:
            raise ValueError(f"{name}: shape {arr.shape} != {cur.shape}")
        if not np.isfinite(arr).all():
            raise ValueError(f"{name}: non-finite values")
        return arr
    if isinstance(cur, Enum):
        ev = type(cur)
        if isinstance(value, ev):
            return value
        if isinstance(value, str):
            try:
                return ev[value.upper()]
            except KeyError:
                raise ValueError(
                    f"{name}: {value!r} not in {[e.name for e in ev]}")
        return ev(value)
    if isinstance(cur, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(cur, int) and not isinstance(cur, bool):
        iv = int(value)
        return iv
    if isinstance(cur, float):
        fv = float(value)
        if not np.isfinite(fv):
            raise ValueError(f"{name}: non-finite value")
        return fv
    if isinstance(cur, str) or cur is None:
        return value if cur is None else str(value)
    raise ValueError(f"{name}: unsupported field type {type(cur).__name__}")


def serialize_component(comp) -> Dict[str, Any]:
    """Component → plain JSON-able dict (opaque caches omitted)."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(comp):
        if f.name in _OPAQUE:
            continue
        v = getattr(comp, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v.tolist()
        elif isinstance(v, Enum):
            out[f.name] = v.name
        else:
            out[f.name] = v
    return out


def apply_component(comp, data: Dict[str, Any]):
    """Dict → component fields, each validated; returns the component."""
    for k, v in data.items():
        setattr(comp, k, _coerce(comp, k, v))
    return comp


def list_entity(registry, entity: int) -> Dict[str, Dict[str, Any]]:
    """All components on an entity, serialized (the Inspector view)."""
    out = {}
    for t in C.ALL_COMPONENT_TYPES:
        comp = registry.try_get(entity, t)
        if comp is not None:
            out[t.__name__.removesuffix("Component")] = serialize_component(comp)
    return out


def get_field(registry, entity: int, comp_name, field_name: str):
    comp = registry.get(entity, component_type(comp_name))
    v = getattr(comp, field_name)
    return v.tolist() if isinstance(v, np.ndarray) else (
        v.name if isinstance(v, Enum) else v)


def set_field(registry, entity: int, comp_name, field_name: str, value):
    """Validated single-field write — the Inspector widget commit. Returns
    the coerced stored value."""
    comp = registry.get(entity, component_type(comp_name))
    coerced = _coerce(comp, field_name, value)
    setattr(comp, field_name, coerced)
    if isinstance(comp, C.TextureComponent) and field_name == "path":
        comp.dirty = True   # same invalidation the panel's path edit does
    return coerced
