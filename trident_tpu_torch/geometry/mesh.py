"""Mesh / material containers and the shared geometry cache.

The reference keeps ONE concatenated device vertex buffer + ONE index buffer
with per-mesh `MeshDrawInfo{FirstIndex, IndexCount, BaseVertex, MaterialIndex}`
slices (Renderer/Renderer.h:293-299, rebuild at Renderer.cpp:1965-2116).
That layout is already ideal for TPU: geometry lives as a handful of big
device arrays, uploaded only when assets change, and the jitted frame
function indexes into them.

Vertex attributes (struct-of-arrays, mirrors Renderer/Vertex.h:9-77):
  position (V,3) f32 | normal (V,3) | tangent (V,3) | bitangent (V,3) |
  color (V,3) | uv (V,2) | bone_indices (V,4) i32 | bone_weights (V,4) f32

The port's own copy of trident_tpu/geometry/mesh.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Material:
    """PBR material (reference: Geometry/Material.h:9-20 + material UBO)."""

    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    ambient_strength: float = 1.0
    base_color_texture: int = -1   # index into ModelData textures, -1 = none
    texture_slot: int = 0          # resolved renderer slot (0 = white)
    name: str = ""

    def packed(self) -> np.ndarray:
        """(8,) f32 row for the material table:
        base_color rgba, metallic, roughness, ambient_strength, reserved."""
        return np.array([*self.base_color, self.metallic, self.roughness,
                         self.ambient_strength, 0.0], dtype=np.float32)


class Mesh:
    """CPU-side mesh with SoA vertex attributes."""

    def __init__(self, positions: np.ndarray, indices: np.ndarray,
                 normals: Optional[np.ndarray] = None,
                 tangents: Optional[np.ndarray] = None,
                 bitangents: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None,
                 uvs: Optional[np.ndarray] = None,
                 bone_indices: Optional[np.ndarray] = None,
                 bone_weights: Optional[np.ndarray] = None,
                 material_index: int = 0,
                 name: str = "",
                 spatial_sort: bool = True) -> None:
        v = positions.shape[0]
        self.positions = np.asarray(positions, dtype=np.float32).reshape(v, 3)
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        if spatial_sort:
            self.indices = morton_order(self.indices, self.positions)
        self.normals = _default(normals, (v, 3), [0.0, 0.0, 1.0])
        self.tangents = _default(tangents, (v, 3), [1.0, 0.0, 0.0])
        self.bitangents = _default(bitangents, (v, 3), [0.0, 1.0, 0.0])
        self.colors = _default(colors, (v, 3), [1.0, 1.0, 1.0])
        self.uvs = _default(uvs, (v, 2), [0.0, 0.0])
        self.bone_indices = (np.asarray(bone_indices, dtype=np.int32).reshape(v, 4)
                             if bone_indices is not None
                             else np.full((v, 4), -1, dtype=np.int32))
        self.bone_weights = _default(bone_weights, (v, 4), [0.0, 0.0, 0.0, 0.0])
        self.material_index = material_index
        self.name = name

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0] // 3

    @property
    def skinned(self) -> bool:
        return bool((self.bone_indices >= 0).any())


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = x.astype(np.uint64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(indices: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Reorder triangle triples by Morton code of their centroid in the
    mesh-local bbox. Consecutive triangles become spatially coherent, which
    is what the raster binner's chunk bboxes rely on (chunks of C
    consecutive triangles must be compact on screen). One-time host cost at
    mesh build; draw order only affects equal-depth tie-breaking."""
    tri = indices.reshape(-1, 3)
    if tri.shape[0] <= 2:
        return indices
    centroid = positions[tri].mean(axis=1)
    lo = centroid.min(axis=0)
    span = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroid - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    order = np.argsort(code, kind="stable")
    return tri[order].reshape(-1)


def _default(value: Optional[np.ndarray], shape: Tuple[int, ...], fill) -> np.ndarray:
    if value is not None:
        return np.asarray(value, dtype=np.float32).reshape(shape)
    out = np.empty(shape, dtype=np.float32)
    out[:] = np.asarray(fill, dtype=np.float32)
    return out


@dataclass(frozen=True)
class MeshDrawInfo:
    """Index-buffer slice for one mesh in the shared buffers."""

    first_index: int
    index_count: int
    base_vertex: int
    material_index: int


@dataclass
class PackedGeometry:
    """The concatenated host arrays, ready for one device_put."""

    positions: np.ndarray      # (V,3) f32
    normals: np.ndarray        # (V,3)
    tangents: np.ndarray       # (V,3)
    bitangents: np.ndarray     # (V,3)
    colors: np.ndarray         # (V,3)
    uvs: np.ndarray            # (V,2)
    bone_indices: np.ndarray   # (V,4) i32
    bone_weights: np.ndarray   # (V,4) f32
    indices: np.ndarray        # (I,) i32 — local to each mesh's base_vertex
    draw_infos: List[MeshDrawInfo] = field(default_factory=list)


class GeometryCache:
    """Accumulates meshes + materials and packs them into the shared-buffer
    layout. `version` bumps on any change so downstream device uploads and
    draw plans know to refresh (the analogue of UploadMeshFromCache)."""

    def __init__(self) -> None:
        self.meshes: List[Mesh] = []
        self.materials: List[Material] = [Material(name="default")]
        self.version: int = 0
        self._packed: Optional[PackedGeometry] = None
        self._packed_version: int = -1
        # source path → (mesh slots, material slots) for hot reload:
        # replace_model patches these slots in place so existing
        # MeshComponent.mesh_index values stay valid across re-imports
        self.model_slots: Dict[str, Tuple[List[int], List[int]]] = {}

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        self.version += 1
        return len(self.materials) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self.version += 1
        return len(self.meshes) - 1

    def append(self, meshes: List[Mesh], materials: List[Material],
               source_path: Optional[str] = None) -> Tuple[int, int]:
        """Append an imported model: offsets mesh material indices by the
        current material base (reference: Renderer::AppendMeshes).
        `source_path` registers the model for hot reload (replace_model).
        Returns (first_mesh_index, first_material_index)."""
        mat_base = len(self.materials)
        mesh_base = len(self.meshes)
        self.materials.extend(materials)
        for m in meshes:
            m.material_index += mat_base
            self.meshes.append(m)
        self.version += 1
        if source_path is not None:
            self.model_slots[source_path] = (
                list(range(mesh_base, mesh_base + len(meshes))),
                list(range(mat_base, mat_base + len(materials))))
        return mesh_base, mat_base

    def replace_model(self, source_path: str, meshes: List[Mesh],
                      materials: List[Material]) -> bool:
        """Hot reload: patch a previously appended model's mesh/material
        slots in place (reference: Renderer.cpp:5739-5820 re-imports a
        changed model file and patches the live geometry buffers). Returns
        False when `source_path` was never appended. Mesh indices held by
        live MeshComponents stay valid: a grown model appends extra slots,
        a shrunk one leaves empty stub meshes in the leftover slots (the
        slot list keeps them for reuse by the next reload)."""
        slots = self.model_slots.get(source_path)
        if slots is None:
            return False
        mesh_slots, mat_slots = slots
        for k, mat in enumerate(materials):
            if k < len(mat_slots):
                self.materials[mat_slots[k]] = mat
            else:
                mat_slots.append(len(self.materials))
                self.materials.append(mat)
        for k, m in enumerate(meshes):
            m.material_index = (mat_slots[m.material_index]
                                if 0 <= m.material_index < len(mat_slots)
                                else 0)
            if k < len(mesh_slots):
                self.meshes[mesh_slots[k]] = m
            else:
                mesh_slots.append(len(self.meshes))
                self.meshes.append(m)
        for k in range(len(meshes), len(mesh_slots)):
            self.meshes[mesh_slots[k]] = Mesh(
                positions=np.zeros((1, 3), np.float32),
                indices=np.zeros((0,), np.int32),
                name=f"{source_path}:removed:{k}")
        self.version += 1
        return True

    def triangle_count(self) -> int:
        return sum(m.triangle_count for m in self.meshes)

    def material_table(self) -> np.ndarray:
        """(M,8) f32 material UBO table."""
        return np.stack([m.packed() for m in self.materials], axis=0)

    def texture_slot_table(self) -> np.ndarray:
        """(M,) i32 resolved texture slot per material."""
        return np.array([m.texture_slot for m in self.materials], dtype=np.int32)

    def packed(self) -> PackedGeometry:
        """Pack (cached by version)."""
        if self._packed is not None and self._packed_version == self.version:
            return self._packed
        if not self.meshes:
            # one dummy vertex: padded draw plans gather index 0 unconditionally
            packed = PackedGeometry(
                positions=np.zeros((1, 3), np.float32),
                normals=np.zeros((1, 3), np.float32),
                tangents=np.zeros((1, 3), np.float32),
                bitangents=np.zeros((1, 3), np.float32),
                colors=np.zeros((1, 3), np.float32),
                uvs=np.zeros((1, 2), np.float32),
                bone_indices=np.full((1, 4), -1, np.int32),
                bone_weights=np.zeros((1, 4), np.float32),
                indices=np.zeros((0,), np.int32),
            )
        else:
            draw_infos: List[MeshDrawInfo] = []
            base_vertex = 0
            first_index = 0
            for m in self.meshes:
                draw_infos.append(MeshDrawInfo(first_index, m.indices.shape[0],
                                               base_vertex, m.material_index))
                base_vertex += m.vertex_count
                first_index += m.indices.shape[0]
            packed = PackedGeometry(
                positions=np.concatenate([m.positions for m in self.meshes]),
                normals=np.concatenate([m.normals for m in self.meshes]),
                tangents=np.concatenate([m.tangents for m in self.meshes]),
                bitangents=np.concatenate([m.bitangents for m in self.meshes]),
                colors=np.concatenate([m.colors for m in self.meshes]),
                uvs=np.concatenate([m.uvs for m in self.meshes]),
                bone_indices=np.concatenate([m.bone_indices for m in self.meshes]),
                bone_weights=np.concatenate([m.bone_weights for m in self.meshes]),
                indices=np.concatenate([m.indices for m in self.meshes]),
                draw_infos=draw_infos,
            )
        self._packed = packed
        self._packed_version = self.version
        return packed
