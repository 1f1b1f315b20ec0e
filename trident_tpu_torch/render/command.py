"""RenderCommand: the static facade, for API parity with the reference.

The reference editor talks to the renderer exclusively through static
pass-throughs (Renderer/RenderCommand.h:14-83). Frontends migrating from it
can keep the same call shapes: `RenderCommand.init(config)` binds a global
Application, and every editor-facing capability is a static method mapping
onto it. New code should prefer using Application/Renderer directly.

The port's copy of trident_tpu/render/command.py: `init(config, device)`
binds a port Application on `device` (the card unless given).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from trident_tpu_torch.core.config import EngineConfig


class RenderCommand:
    _app = None

    # -- lifecycle ------------------------------------------------------------
    @classmethod
    def init(cls, config: Optional[EngineConfig] = None, device=None):
        from trident_tpu_torch.app import Application

        cls._app = Application(config, device=device)
        return cls._app

    @classmethod
    def shutdown(cls) -> None:
        if cls._app is not None:
            cls._app.shutdown()
            cls._app = None

    @classmethod
    def app(cls):
        if cls._app is None:
            raise RuntimeError("RenderCommand.init() first")
        return cls._app

    @classmethod
    def renderer(cls):
        return cls.app().renderer

    # -- frame / registry -------------------------------------------------------
    @classmethod
    def draw_frame(cls):
        return cls.app().render()

    @classmethod
    def get_registry(cls):
        return cls.app().scene.registry

    @classmethod
    def set_active_registry(cls, registry) -> None:
        cls.renderer().set_active_registry(registry)

    # -- viewports ----------------------------------------------------------------
    @classmethod
    def set_viewport(cls, viewport_id: int, width: int, height: int) -> None:
        cls.renderer().set_viewport(viewport_id, width, height)

    @classmethod
    def get_viewport_texture(cls, viewport_id: int) -> np.ndarray:
        """The offscreen image a UI would show (ImGui descriptor analogue)."""
        return cls.renderer().present(viewport_id)

    # -- shaders ------------------------------------------------------------------
    @classmethod
    def set_custom_shader(cls, path: str) -> bool:
        """Install a hot-reloadable user shading module (the reference's
        GLSL-pipeline analogue; render/shader_hook.py contract). Edits to
        the file under Assets/Shaders reload automatically each frame."""
        return cls.renderer().set_custom_shader(path)

    @classmethod
    def clear_custom_shader(cls) -> None:
        cls.renderer().clear_custom_shader()

    # -- cameras ----------------------------------------------------------------
    @classmethod
    def set_editor_camera(cls, position, target=None) -> None:
        cam = cls.renderer().editor_camera
        cam.set_position(position)
        if target is not None:
            cam.look_at_target(target)

    @classmethod
    def set_runtime_camera_ready(cls, ready: bool) -> None:
        cls.renderer().runtime_camera_ready = ready

    # -- transforms (gizmo writes) ----------------------------------------------
    @classmethod
    def set_world_transform(cls, entity: int, matrix: np.ndarray) -> None:
        from trident_tpu_torch.ecs.components import TransformComponent
        from trident_tpu_torch.mathx.transforms import decompose_trs

        t = cls.get_registry().get(entity, TransformComponent)
        t.position, t.rotation, t.scale = decompose_trs(np.asarray(matrix))

    @classmethod
    def get_world_transform(cls, entity: int) -> np.ndarray:
        from trident_tpu_torch.ecs.components import TransformComponent
        from trident_tpu_torch.mathx.transforms import compose_trs

        t = cls.get_registry().get(entity, TransformComponent)
        return np.asarray(compose_trs(t.position, t.rotation, t.scale))

    @classmethod
    def pick_entity(cls, x: int, y: int, viewport_id=None):
        """Entity under a viewport pixel, or None (viewport selection,
        SceneViewportPanel.cpp:63-100)."""
        return cls.renderer().pick_entity(x, y, viewport_id)

    # -- inspector (component editing, Panels/InspectorPanel.cpp analogue) -----
    @classmethod
    def inspect_entity(cls, entity: int):
        """All components on the entity as plain dicts."""
        from trident_tpu_torch.ecs.inspect import list_entity

        return list_entity(cls.get_registry(), entity)

    @classmethod
    def get_component_field(cls, entity: int, component: str, field: str):
        from trident_tpu_torch.ecs.inspect import get_field

        return get_field(cls.get_registry(), entity, component, field)

    @classmethod
    def set_component_field(cls, entity: int, component: str, field: str,
                            value):
        """Validated component-field write (shape/enum/type checked)."""
        from trident_tpu_torch.ecs.inspect import set_field

        return set_field(cls.get_registry(), entity, component, field, value)

    @classmethod
    def component_schema(cls, component: str):
        from trident_tpu_torch.ecs.inspect import component_schema

        return component_schema(component)

    # -- assets ---------------------------------------------------------------
    @classmethod
    def append_meshes(cls, meshes, materials) -> Tuple[int, int]:
        return cls.renderer().append_meshes(meshes, materials)

    @classmethod
    def import_assets(cls, paths: List[str]) -> List[int]:
        return cls.app().import_assets(paths)

    # -- text / overlay -----------------------------------------------------------
    @classmethod
    def queue_text(cls, viewport_id: int, text: str, x: int, y: int,
                   color=(1, 1, 1, 1), size: int = 16) -> None:
        cls.renderer().queue_text(viewport_id, text, x, y, color, size)

    # -- telemetry ----------------------------------------------------------------
    @classmethod
    def get_frame_timing_stats(cls):
        return cls.renderer().timing.stats()

    @classmethod
    def begin_performance_capture(cls) -> None:
        cls.renderer().timing.begin_capture()

    @classmethod
    def end_performance_capture(cls) -> Optional[str]:
        return cls.renderer().timing.end_capture()

    @classmethod
    def get_ai_debug_stats(cls):
        return cls.app().frame_generator.stats

    # -- AI blend -------------------------------------------------------------
    @classmethod
    def set_ai_blend_strength(cls, blend: float) -> None:
        cls.app().config.ai.blend = float(blend)

    # -- dataset capture -----------------------------------------------------------
    @classmethod
    def set_dataset_capture_enabled(cls, enabled: bool) -> None:
        rec = cls.app().dataset_recorder
        rec.start() if enabled else rec.stop()

    @classmethod
    def configure_dataset_capture(cls, directory: str, interval_s: float) -> None:
        rec = cls.app().dataset_recorder
        rec.directory = directory
        rec.interval_s = interval_s

    # -- video recording ------------------------------------------------------------
    @classmethod
    def set_viewport_recording_enabled(cls, enabled: bool, path: str = "capture.y4m",
                                       fps: int = 30) -> bool:
        enc = cls.app().video_encoder
        if enabled and not enc.active:
            ctx = cls.renderer().viewports[cls.renderer().active_viewport]
            return enc.begin_session(path, ctx.width, ctx.height, fps)
        if not enabled and enc.active:
            enc.end_session()
        return True
