"""Directory batch import: scan for model files, spawn entities per mesh.

Reference: Loader/SceneLoader.{h,cpp} — scan a directory for importable
files, load each, spawn ECS entities per mesh instance with decomposed
transforms + tag.

The port's own copy of trident_tpu/assets/scene_loader.py: the port imports
nothing of the JAX package. Texture files load through io/image.py::
load_rgba8_mips.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from trident_tpu_torch.assets.model_loader import load_model
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.ecs.components import MeshComponent, TagComponent, TransformComponent
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.mathx.transforms import decompose_trs

logger = get_logger("assets.scene")

SUPPORTED_EXTENSIONS = (".obj", ".gltf", ".glb", ".fbx", ".dae", ".stl",
                        ".ply")


def load_scene_directory(directory: str, registry: Registry, renderer) -> List[int]:
    """Import every supported model under `directory`; returns new entities."""
    entities: List[int] = []
    for root, _dirs, files in os.walk(directory):
        for name in sorted(files):
            if os.path.splitext(name)[1].lower() not in SUPPORTED_EXTENSIONS:
                continue
            path = os.path.join(root, name)
            try:
                entities.extend(import_model_entities(path, registry, renderer))
            except Exception as exc:
                logger.warning("scene import skipped %s: %s", path, exc)
    return entities


def resolve_model_textures(data, renderer) -> None:
    """Resolve a loaded model's textures into renderer slots (file-backed
    or embedded pixels) and patch its materials' texture_slot fields."""
    for tex in data.textures:
        try:
            if tex.rgba is not None:
                renderer.acquire_texture(tex.path, tex.rgba)
            else:
                from trident_tpu_torch.io.image import load_rgba8_mips

                rgba, mips = load_rgba8_mips(tex.path)
                renderer.acquire_texture(tex.path, rgba, mips=mips)
        except Exception as exc:
            logger.warning("texture %s failed: %s", tex.path, exc)
    for mat in data.materials:
        if 0 <= mat.base_color_texture < len(data.textures):
            mat.texture_slot = renderer.textures.lookup(
                data.textures[mat.base_color_texture].path)


def import_model_entities(path: str, registry: Registry, renderer,
                          tag: Optional[str] = None) -> List[int]:
    """Load a model, upload its meshes, create one entity per mesh instance
    (the ImportDroppedAssets flow)."""
    data = load_model(path)
    import numpy as np

    resolve_model_textures(data, renderer)

    mesh_base, _mat_base = renderer.append_meshes(data.meshes, data.materials,
                                                  source_path=path)

    if data.skeleton is not None or data.clips:
        from trident_tpu_torch.anim.service import AnimationAssetService

        AnimationAssetService.get().register_runtime_asset(
            path, data.skeleton, data.clips)

    entities: List[int] = []
    base_tag = tag or os.path.splitext(os.path.basename(path))[0]
    for i, mesh in enumerate(data.meshes):
        e = registry.create()
        t = registry.add(e, TransformComponent())
        xf = (data.instance_transforms[i]
              if i < len(data.instance_transforms) else np.eye(4, dtype=np.float32))
        pos, rot, scale = decompose_trs(xf)
        t.position, t.rotation, t.scale = pos, rot, scale
        registry.add(e, TagComponent(f"{base_tag}:{mesh.name or i}"))
        registry.add(e, MeshComponent(
            mesh_index=mesh_base + i,
            material_index=mesh.material_index,
            source_asset_path=path,
            source_mesh_index=i,
        ))
        entities.append(e)
    return entities
