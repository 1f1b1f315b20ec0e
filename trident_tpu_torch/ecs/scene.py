"""Scene: save/load (.trident text format), play-mode sandboxing, update.

Reference: ECS/Scene.{h,cpp} — line-based text serialization of every
component (SerializeEntity, Scene.cpp:288-430), Play = deep-clone the editor
registry into a runtime registry (:153-201), Stop restores (:203-240),
Update drives scripts + the animation system (:242-270), Load rebuilds
renderer geometry from recorded SourceAsset paths / primitive flags
(:1004-1081), and a default camera entity is seeded at (0,100,255) (:41-68).

The format keeps the reference's line shapes (Entity/UUID/Tag/Transform/
Camera/Mesh/Sprite/Texture/Animation/Light/Script/EndEntity) so scenes are
hand-editable and migratable.

The port's own copy of trident_tpu/ecs/scene.py: the port imports nothing
of the JAX package, and the files of the two are interchangeable. Play and
update run the AnimationSystem on the renderer's device (or, without a
renderer, on `device`: the card when None).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional

import numpy as np

from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.ecs.components import (
    AnimationComponent,
    CameraComponent,
    LightComponent,
    LightType,
    MeshComponent,
    ProjectionType,
    ScriptComponent,
    SpriteComponent,
    TagComponent,
    TextureComponent,
    TransformComponent,
    UUIDComponent,
)
from trident_tpu_torch.ecs.registry import Entity, Registry
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.utils.profiling import TRACER

logger = get_logger("scene")


def _escape(s: str) -> str:
    # newlines MUST be escaped: the format is line-based, so a raw newline
    # inside a quoted tag/path writes a file save() accepts but load()
    # rejects with "unterminated string"
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n").replace("\r", "\\r"))


def _fmt(v: float) -> str:
    return f"{float(v):.6g}"


def _parse_quoted(text: str, start: int = 0):
    """Parse a double-quoted, escaped string starting at text[start] == '"'.
    Returns (value, index_after_closing_quote)."""
    assert text[start] == '"'
    out = []
    i = start + 1
    while i < len(text):
        ch = text[i]
        if ch == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            out.append({"n": "\n", "r": "\r"}.get(nxt, nxt))
            i += 2
            continue
        if ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated string in: {text!r}")


def _kv_fields(text: str) -> Dict[str, str]:
    """Parse `Key=value` / `Key="quoted"` fields from a line fragment."""
    fields: Dict[str, str] = {}
    i = 0
    n = len(text)
    while i < n:
        while i < n and text[i] == " ":
            i += 1
        if i >= n:
            break
        eq = text.find("=", i)
        if eq < 0:
            break
        key = text[i:eq]
        if eq + 1 < n and text[eq + 1] == '"':
            value, i = _parse_quoted(text, eq + 1)
        else:
            end = text.find(" ", eq + 1)
            end = n if end < 0 else end
            value = text[eq + 1:end]
            i = end
        fields[key] = value
    return fields


class Scene:
    """Owns the editor registry; play() sandboxes into a runtime clone."""

    def __init__(self, registry: Optional[Registry] = None, renderer=None,
                 device=None) -> None:
        self.editor_registry = registry or Registry()
        self.runtime_registry: Optional[Registry] = None
        self.renderer = renderer
        self.device = device
        self.playing = False
        self.paused = False
        self.script_runner: Optional[Callable] = None
        self._seed_default_camera()

    # -- registry access -------------------------------------------------------
    @property
    def registry(self) -> Registry:
        return self.runtime_registry if self.playing else self.editor_registry

    @property
    def animation_device(self):
        """Where the AnimationSystem samples: the renderer's device when
        the scene has a renderer, else `device` (None: the card)."""
        return self.renderer.device if self.renderer is not None else self.device

    def _seed_default_camera(self) -> None:
        if self.editor_registry.single(CameraComponent) is None:
            e = self.editor_registry.create()
            t = self.editor_registry.add(e, TransformComponent())
            t.position = np.array([0.0, 100.0, 255.0], np.float32)
            self.editor_registry.add(e, TagComponent("Main Camera"))
            self.editor_registry.add(e, CameraComponent(primary=True))

    # -- play mode ---------------------------------------------------------------
    def play(self) -> None:
        if self.playing:
            return
        self.runtime_registry = self.editor_registry.clone()
        for _e, (anim,) in self.runtime_registry.view(AnimationComponent):
            anim.time = 0.0
            anim.playing = True
        for _e, (script,) in self.runtime_registry.view(ScriptComponent):
            script.running = script.autostart
        self.playing = True
        from trident_tpu_torch.anim.system import AnimationSystem

        self.paused = False
        AnimationSystem.initialise_pose(self.runtime_registry,
                                        device=self.animation_device)
        if self.renderer is not None:
            self.renderer.set_active_registry(self.runtime_registry)
            self.renderer.bind_runtime_camera(self.runtime_registry)

    def pause(self, paused: bool = True) -> None:
        """Freeze runtime updates without destroying the sandbox (the
        toolbar pause button)."""
        self.paused = paused

    def find_by_tag(self, tag: str) -> List[Entity]:
        """Hierarchy-panel style lookup in the ACTIVE registry."""
        return [e for e, (t,) in self.registry.view(TagComponent) if t.tag == tag]

    def entity_names(self) -> List[tuple]:
        """(entity, tag) list — what the hierarchy panel shows."""
        out = []
        for e in self.registry.alive():
            t = self.registry.try_get(e, TagComponent)
            out.append((e, t.tag if t else f"Entity {e}"))
        return out

    def stop(self) -> None:
        if not self.playing:
            return
        self.playing = False
        self.paused = False
        self.runtime_registry = None
        if self.renderer is not None:
            self.renderer.set_active_registry(self.editor_registry)
            self.renderer.runtime_camera_ready = False

    def update(self, dt: float) -> None:
        """Per-frame runtime logic: scripts + skeletal animation (the
        tracer's span `anim`, utils/profiling.py)."""
        if not self.playing or self.paused:
            return
        with TRACER.span("anim"):
            self._update(dt)

    def _update(self, dt: float) -> None:
        registry = self.runtime_registry
        # snapshot: a script destroying an entity mutates Registry._alive
        # mid-iteration and would silently skip the NEXT entity's update
        for entity, (script,) in list(registry.view(ScriptComponent)):
            if not script.running:
                continue
            if self.script_runner is not None:
                self.script_runner(entity, registry, script, dt)
            elif script.module:
                self._run_script_module(entity, registry, script, dt)
        from trident_tpu_torch.anim.system import AnimationSystem

        AnimationSystem.update(registry, dt, device=self.animation_device)

    @staticmethod
    def _run_script_module(entity: Entity, registry: Registry,
                           script: ScriptComponent, dt: float) -> None:
        import importlib

        try:
            mod_name, _, fn_name = script.module.partition(":")
            fn = getattr(importlib.import_module(mod_name), fn_name or "update")
            fn(entity, registry, dt)
        except Exception as exc:  # scripts must not kill the frame loop
            logger.warning("script %s failed: %s", script.module, exc)
            script.running = False

    # -- serialization -----------------------------------------------------------
    def save(self, path: str) -> None:
        registry = self.editor_registry
        lines: List[str] = ["TridentScene 1"]
        for entity in registry.alive():
            lines.append(f"Entity {entity}")
            uuid = registry.try_get(entity, UUIDComponent)
            if uuid is not None:
                lines.append(f"UUID {uuid.uuid}")
            tag = registry.try_get(entity, TagComponent)
            if tag is not None:
                lines.append(f'Tag "{_escape(tag.tag)}"')
            tr = registry.try_get(entity, TransformComponent)
            if tr is not None:
                v = [*tr.position, *tr.rotation, *tr.scale]
                lines.append("Transform " + " ".join(_fmt(x) for x in v))
            cam = registry.try_get(entity, CameraComponent)
            if cam is not None:
                lines.append(
                    f"Camera {cam.projection.value} {_fmt(cam.fov_deg)} "
                    f"{_fmt(cam.ortho_size)} {_fmt(cam.near_clip)} {_fmt(cam.far_clip)} "
                    f"{int(cam.primary)} {int(cam.fixed_aspect)} {_fmt(cam.aspect)}")
            mesh = registry.try_get(entity, MeshComponent)
            if mesh is not None:
                line = (f"Mesh {mesh.mesh_index} {mesh.material_index} 0 0 0 "
                        f"{int(mesh.visible)} {mesh.primitive.value}")
                if mesh.source_asset_path:
                    line += (f' SourceAsset="{_escape(mesh.source_asset_path)}"'
                             f" SourceMeshIndex={mesh.source_mesh_index}")
                if not np.allclose(mesh.tint, 1.0):
                    # render-affecting state (frame.py folds tint into the
                    # shade table) — a round-trip must not change the image
                    line += f" Tint={','.join(_fmt(x) for x in mesh.tint)}"
                lines.append(line)
            spr = registry.try_get(entity, SpriteComponent)
            if spr is not None:
                lines.append(
                    f'Sprite Texture="{_escape(spr.texture_path)}" '
                    f"Tint={','.join(_fmt(x) for x in spr.tint)} "
                    f"UVScale={','.join(_fmt(x) for x in spr.uv_scale)} "
                    f"UVOffset={','.join(_fmt(x) for x in spr.uv_offset)} "
                    f"Tiling={_fmt(spr.tiling)} Visible={int(spr.visible)} "
                    f"AtlasTiles={spr.atlas_tiles} AtlasIndex={spr.atlas_index} "
                    f"AnimationSpeed={_fmt(spr.animation_speed)} "
                    f"SortOffset={_fmt(spr.sort_offset)}")
            tex = registry.try_get(entity, TextureComponent)
            if tex is not None:
                line = (f'Texture "{_escape(tex.path)}" Slot={tex.slot} '
                        f"Dirty={int(tex.dirty)}")
                if not np.allclose(tex.uv_scale, 1.0):
                    line += f" UVScale={','.join(_fmt(x) for x in tex.uv_scale)}"
                if np.any(tex.uv_offset):
                    line += f" UVOffset={','.join(_fmt(x) for x in tex.uv_offset)}"
                if tex.tiling != 1.0:
                    line += f" Tiling={_fmt(tex.tiling)}"
                lines.append(line)
            anim = registry.try_get(entity, AnimationComponent)
            if anim is not None:
                bones = anim.bone_matrices
                count = 0 if bones is None else len(bones)
                lines.append(
                    f'Animation Skeleton="{_escape(anim.skeleton_asset)}" '
                    f'Animation="{_escape(anim.animation_asset)}" '
                    f'Clip="{_escape(anim.clip_name)}" Time={_fmt(anim.time)} '
                    f"Speed={_fmt(anim.speed)} Playing={int(anim.playing)} "
                    f"Looping={int(anim.looping)} BoneCount={count}")
                if count:
                    flat = np.asarray(bones, np.float32).reshape(-1)
                    lines.append("AnimationBones " + " ".join(_fmt(x) for x in flat))
            light = registry.try_get(entity, LightComponent)
            if light is not None:
                lines.append(
                    f"Light {light.light_type.value} "
                    f"{' '.join(_fmt(x) for x in light.color)} {_fmt(light.intensity)} "
                    f"{' '.join(_fmt(x) for x in light.direction)} {_fmt(light.range)} "
                    f"{int(light.enabled)} {int(light.cast_shadows)} 0 0")
            script = registry.try_get(entity, ScriptComponent)
            if script is not None:
                lines.append(f'Script "{_escape(script.path)}" '
                             f"AutoStart={int(script.autostart)} "
                             f'Module="{_escape(script.module)}"')
            lines.append("EndEntity")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        logger.info("saved scene with %d entities to %s", len(registry), path)

    def load(self, path: str, asset_importer: Optional[Callable[[str], tuple]] = None) -> None:
        """Load a scene file into a fresh editor registry.

        `asset_importer(path) -> (first_mesh_index, mesh_count)` re-imports a
        source asset into the renderer's geometry cache (the
        RebuildMeshAssetsFromComponents analogue); primitives rebuild through
        the renderer directly.
        """
        if self.playing:
            self.stop()
        registry = Registry()
        with open(path) as f:
            text = f.read()
        entity: Optional[Entity] = None
        last_anim: Optional[AnimationComponent] = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("TridentScene"):
                continue
            word, _, rest = line.partition(" ")
            if word == "Entity":
                entity = registry.create()
                last_anim = None
            elif word == "EndEntity":
                entity = None
            elif entity is None:
                continue
            elif word == "UUID":
                registry.get(entity, UUIDComponent).uuid = int(rest)
            elif word == "Tag":
                value, _ = _parse_quoted(rest.strip())
                registry.add(entity, TagComponent(value))
            elif word == "Transform":
                v = [float(x) for x in rest.split()]
                t = TransformComponent()
                t.position = np.array(v[0:3], np.float32)
                t.rotation = np.array(v[3:6], np.float32)
                t.scale = np.array(v[6:9], np.float32)
                registry.add(entity, t)
            elif word == "Camera":
                v = rest.split()
                registry.add(entity, CameraComponent(
                    projection=ProjectionType(int(v[0])), fov_deg=float(v[1]),
                    ortho_size=float(v[2]), near_clip=float(v[3]),
                    far_clip=float(v[4]), primary=bool(int(v[5])),
                    fixed_aspect=bool(int(v[6])), aspect=float(v[7])))
            elif word == "Mesh":
                head = rest
                kv: Dict[str, str] = {}
                m_kv = re.search(r"\b[A-Za-z]\w*=", rest)
                if m_kv:
                    head, kv = rest[:m_kv.start()], _kv_fields(rest[m_kv.start():])
                v = head.split()
                comp = MeshComponent(
                    mesh_index=int(v[0]), material_index=int(v[1]),
                    visible=bool(int(v[5])), primitive=PrimitiveType(int(v[6])),
                    source_asset_path=kv.get("SourceAsset", ""),
                    source_mesh_index=int(kv.get("SourceMeshIndex", -1)))
                if "Tint" in kv:
                    comp.tint = np.array(
                        [float(x) for x in kv["Tint"].split(",")], np.float32)
                registry.add(entity, comp)
            elif word == "Sprite":
                kv = _kv_fields(rest)
                spr = SpriteComponent(texture_path=kv.get("Texture", ""))
                if "Tint" in kv:
                    spr.tint = np.array([float(x) for x in kv["Tint"].split(",")], np.float32)
                if "UVScale" in kv:
                    spr.uv_scale = np.array([float(x) for x in kv["UVScale"].split(",")], np.float32)
                if "UVOffset" in kv:
                    spr.uv_offset = np.array([float(x) for x in kv["UVOffset"].split(",")], np.float32)
                spr.tiling = float(kv.get("Tiling", 1.0))
                spr.visible = bool(int(kv.get("Visible", 1)))
                spr.atlas_tiles = int(float(kv.get("AtlasTiles", "1").split(",")[0]))
                spr.atlas_index = int(kv.get("AtlasIndex", 0))
                spr.animation_speed = float(kv.get("AnimationSpeed", 0.0))
                spr.sort_offset = float(kv.get("SortOffset", 0.0))
                registry.add(entity, spr)
            elif word == "Texture":
                value, after = _parse_quoted(rest.strip())
                kv = _kv_fields(rest.strip()[after:])
                tex = TextureComponent(
                    path=value, slot=int(kv.get("Slot", 0)),
                    dirty=bool(int(kv.get("Dirty", 1))))
                if "UVScale" in kv:
                    tex.uv_scale = np.array(
                        [float(x) for x in kv["UVScale"].split(",")], np.float32)
                if "UVOffset" in kv:
                    tex.uv_offset = np.array(
                        [float(x) for x in kv["UVOffset"].split(",")], np.float32)
                tex.tiling = float(kv.get("Tiling", 1.0))
                registry.add(entity, tex)
            elif word == "Animation":
                kv = _kv_fields(rest)
                last_anim = AnimationComponent(
                    skeleton_asset=kv.get("Skeleton", ""),
                    animation_asset=kv.get("Animation", ""),
                    clip_name=kv.get("Clip", ""),
                    time=float(kv.get("Time", 0.0)),
                    speed=float(kv.get("Speed", 1.0)),
                    playing=bool(int(kv.get("Playing", 0))),
                    looping=bool(int(kv.get("Looping", 1))))
                registry.add(entity, last_anim)
            elif word == "AnimationBones" and last_anim is not None:
                flat = np.array([float(x) for x in rest.split()], np.float32)
                last_anim.bone_matrices = flat.reshape(-1, 4, 4)
            elif word == "Light":
                v = rest.split()
                registry.add(entity, LightComponent(
                    light_type=LightType(int(v[0])),
                    color=np.array([float(x) for x in v[1:4]], np.float32),
                    intensity=float(v[4]),
                    direction=np.array([float(x) for x in v[5:8]], np.float32),
                    range=float(v[8]), enabled=bool(int(v[9])),
                    cast_shadows=bool(int(v[10]))))
            elif word == "Script":
                value, after = _parse_quoted(rest.strip())
                kv = _kv_fields(rest.strip()[after:])
                registry.add(entity, ScriptComponent(
                    path=value, autostart=bool(int(kv.get("AutoStart", 0))),
                    module=kv.get("Module", "")))

        self.editor_registry = registry
        self._rebuild_geometry(asset_importer)
        self._rebuild_textures()
        if self.renderer is not None:
            self.renderer.set_active_registry(registry)
        self._seed_default_camera()
        logger.info("loaded scene with %d entities from %s", len(registry), path)

    def _rebuild_geometry(self, asset_importer) -> None:
        """Re-resolve MeshComponent.mesh_index: primitives via the renderer's
        cache, imported assets via the provided importer (Scene.cpp:1004-1081)."""
        if self.renderer is None:
            return
        imported: Dict[str, int] = {}
        for entity, (mesh,) in self.editor_registry.view(MeshComponent):
            if mesh.primitive != PrimitiveType.NONE:
                mesh.mesh_index = self.renderer.ensure_primitive(mesh.primitive)
            elif mesh.source_asset_path and asset_importer is not None:
                if mesh.source_asset_path not in imported:
                    first, _count = asset_importer(mesh.source_asset_path)
                    imported[mesh.source_asset_path] = first
                base = imported[mesh.source_asset_path]
                mesh.mesh_index = base + max(mesh.source_mesh_index, 0)
            elif mesh.mesh_index >= len(self.renderer.geometry.meshes):
                mesh.mesh_index = -1
                mesh.visible = False

    def _rebuild_textures(self) -> None:
        """Re-resolve TextureComponent.slot from the PATH: saved slots are
        session-local acquire order, so in a fresh process a verbatim slot
        points at the white fallback or an unrelated texture. Keys already
        acquired this session resolve by lookup; on-disk paths re-acquire;
        anything else degrades to slot 0 (white) and stays dirty."""
        if self.renderer is None:
            return
        for _e, (tex,) in self.editor_registry.view(TextureComponent):
            if not tex.path:
                continue
            slot = self.renderer.textures.lookup(tex.path)
            if slot:
                tex.slot, tex.dirty = slot, False
            elif os.path.isfile(tex.path):
                try:
                    from trident_tpu_torch.io.image import load_rgba8_mips

                    rgba, mips = load_rgba8_mips(tex.path)
                    tex.slot = self.renderer.acquire_texture(
                        tex.path, rgba, mips=mips)
                    tex.dirty = False
                except Exception as exc:
                    logger.warning("texture %s failed to reload: %s",
                                   tex.path, exc)
                    tex.slot, tex.dirty = 0, True
            else:
                tex.slot, tex.dirty = 0, True
