from trident_tpu_torch.ecs.registry import Registry, Entity, from_reference
from trident_tpu_torch.ecs.components import (
    TransformComponent,
    MeshComponent,
    CameraComponent,
    LightComponent,
    SpriteComponent,
    TextureComponent,
    TagComponent,
    UUIDComponent,
    ScriptComponent,
    AnimationComponent,
    LightType,
    ProjectionType,
)

__all__ = [
    "Registry", "Entity", "from_reference",
    "TransformComponent", "MeshComponent", "CameraComponent", "LightComponent",
    "SpriteComponent", "TextureComponent", "TagComponent", "UUIDComponent",
    "ScriptComponent", "AnimationComponent", "LightType", "ProjectionType",
]
