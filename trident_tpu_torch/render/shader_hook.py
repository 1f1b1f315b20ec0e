"""Hot-reloadable user shading modules (port of
trident_tpu/render/shader_hook.py, the GLSL-pipeline-reload analogue).

The reference watches fragment-shader source on disk and rebuilds its
pipeline when it changes, keeping the old pipeline when the new source
fails to compile (Pipeline.cpp:997-1058). Here the "shader" is a Python
module defining a `shade(...)` function of torch tensors that replaces the
built-in Cook-Torrance lighting (ops/shading.shade_pbr). A reload swaps in
a new function and bumps `version`, which the Renderer's frame key and
idle-frame signature carry: the next frame captures a new CUDA graph on
the card (render/graphs.py), as a pipeline rebuild would. A module that
fails to import, or has no callable `shade`, keeps the previous function
live and `load` returns False (the reference's failed-compile semantics;
nothing about the device falls back).

Shader module contract:

    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        '''world/normal/albedo (H, W, 3) f32 tensors; metallic/roughness/
        ambient_strength (H, W, 1); camera_pos (3,); lights is
        render/types.LightParams; dir_shadow (H, W, 1) directional-light
        shadow factor or None. Return (H, W, 3) linear HDR rgb.'''

Every tensor is on the frame's device. On the card `shade` runs inside a
CUDA graph capture: it must launch device work only. Anything that waits
for the device (`.item()`, `.cpu()`, `print` of a tensor, a Python `if`
on a tensor's value, `torch.tensor(..., device="cuda")`) makes the capture
raise, and render_viewport raises with it, as for any capture hazard.
The engine applies the tonemap, the background and the AI blend around it
unchanged, so a custom shader composes with shadows, bloom and
supersampling.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class ShaderHook:
    """The active custom shading function and its file.

    `fn` is None when no custom shader is set (the engine uses the built-in
    PBR). `version` increments on every successful (re)load and on
    `clear`; `last_error` holds the last failed load's diagnostic."""

    def __init__(self) -> None:
        self.path: Optional[str] = None
        self.fn: Optional[Callable] = None
        self.version: int = 0
        self.last_error: Optional[str] = None

    def load(self, path: str) -> bool:
        """(Re)load `path` as the active shader module; True on success.
        On any failure (import error, missing or non-callable `shade`) the
        previous function stays live and `last_error` says why."""
        try:
            name = f"_trident_torch_custom_shader_v{self.version + 1}"
            spec = importlib.util.spec_from_file_location(name, path)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load module from {path}")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            fn = getattr(module, "shade", None)
            if not callable(fn):
                raise AttributeError(
                    f"{path} does not define a callable `shade`")
        except Exception as exc:  # keep the old shader live
            self.last_error = f"{type(exc).__name__}: {exc}"
            logger.warning("custom shader %s failed to load (%s); keeping "
                           "previous shader", path, self.last_error)
            return False
        self.path = os.path.abspath(path)
        self.fn = fn
        self.version += 1
        self.last_error = None
        logger.info("custom shader loaded: %s (v%d)", path, self.version)
        return True

    def clear(self) -> None:
        """Back to the built-in PBR."""
        self.path = None
        self.fn = None
        self.version += 1
        self.last_error = None

    def matches(self, path: str) -> bool:
        """Is `path` the file of the active shader? (A file watcher's
        events carry their own spelling of the path.)"""
        if self.path is None:
            return False
        try:
            return os.path.samefile(path, self.path)
        except OSError:
            return os.path.abspath(path) == self.path
