from trident_tpu_torch.geometry.mesh import Mesh, Material, MeshDrawInfo, GeometryCache
from trident_tpu_torch.geometry.primitives import build_quad, build_cube, build_sphere, PrimitiveType

__all__ = [
    "Mesh", "Material", "MeshDrawInfo", "GeometryCache",
    "build_quad", "build_cube", "build_sphere", "PrimitiveType",
]
