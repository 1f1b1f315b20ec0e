"""Model loading: OBJ/MTL and glTF/GLB → ModelData.

The reference funnels every format through Assimp (Loader/ModelLoader.cpp:
triangulate, tangent generation, ≤4 bone weights with renormalization,
Mixamo name normalization, clips baked in seconds). Assimp isn't available
here, so the loaders are written from scratch with the same output contract:
shared-Vertex meshes + PBR materials + optional skeleton/clips, triangle
order kept spatially coherent for the raster binner.

OBJ: full v/vt/vn + fan triangulation + MTL (Kd/Ks/map_Kd/Pm/Pr).
glTF (.gltf/.glb): see assets/gltf_loader.py (meshes, materials, skins,
animations). STL and PLY: assets/stl_ply_loader.py. FBX (binary 7.x and
ASCII): assets/fbx_loader.py. COLLADA: assets/dae_loader.py.

The port's own copy of trident_tpu/assets/model_loader.py: the port imports
nothing of the JAX package. With prefer_native, .obj files go through the
port's native loader (assets/native.py, native/loader.cpp), whose ModelData
is load_obj's bit for bit; when it cannot be built, load_obj.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from trident_tpu_torch.anim.data import AnimationClip, Skeleton
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.geometry.mesh import Material, Mesh

logger = get_logger("assets")


@dataclass
class TextureRef:
    path: str                       # resolved path, or a cache key for embedded data
    name: str
    rgba: Optional[np.ndarray] = None  # decoded pixels for embedded images


@dataclass
class ModelData:
    meshes: List[Mesh] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    textures: List[TextureRef] = field(default_factory=list)
    skeleton: Optional[Skeleton] = None
    clips: List[AnimationClip] = field(default_factory=list)
    # per-mesh node transform (instances), parallel to meshes
    instance_transforms: List[np.ndarray] = field(default_factory=list)


def load_model(path: str, prefer_native: bool = True) -> ModelData:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        if prefer_native:
            from trident_tpu_torch.assets.native import load_obj_native

            data = load_obj_native(path)
            if data is not None:
                return data
        return load_obj(path)
    if ext in (".gltf", ".glb"):
        from trident_tpu_torch.assets.gltf_loader import load_gltf

        return load_gltf(path)
    if ext == ".fbx":
        from trident_tpu_torch.assets.fbx_loader import load_fbx

        return load_fbx(path)
    if ext == ".dae":
        from trident_tpu_torch.assets.dae_loader import load_dae

        return load_dae(path)
    if ext == ".stl":
        from trident_tpu_torch.assets.stl_ply_loader import load_stl

        return load_stl(path)
    if ext == ".ply":
        from trident_tpu_torch.assets.stl_ply_loader import load_ply

        return load_ply(path)
    raise ValueError(f"unsupported model format: {ext!r} ({path})")


# -- OBJ -----------------------------------------------------------------------

def _parse_mtl(path: str) -> Tuple[Dict[str, Material], List[TextureRef]]:
    materials: Dict[str, Material] = {}
    textures: List[TextureRef] = []
    current: Optional[Material] = None
    base_dir = os.path.dirname(path)
    try:
        lines = open(path, errors="replace").read().splitlines()
    except OSError:
        return materials, textures
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].lower()
        if key == "newmtl" and len(parts) > 1:
            current = Material(name=parts[1])
            materials[parts[1]] = current
        elif current is None:
            continue
        elif key == "kd" and len(parts) >= 4:
            current.base_color = (float(parts[1]), float(parts[2]), float(parts[3]), 1.0)
        elif key == "d" and len(parts) >= 2:
            c = current.base_color
            current.base_color = (c[0], c[1], c[2], float(parts[1]))
        elif key == "ns" and len(parts) >= 2:
            # shininess → roughness (Blinn-Phong to PBR approximation)
            ns = float(parts[1])
            current.roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.045, 1.0))
        elif key in ("pm",) and len(parts) >= 2:       # PBR extension
            current.metallic = float(parts[1])
        elif key in ("pr",) and len(parts) >= 2:
            current.roughness = float(parts[1])
        elif key == "map_kd" and len(parts) >= 2:
            tex_path = os.path.normpath(os.path.join(base_dir, parts[-1]))
            current.base_color_texture = len(textures)
            textures.append(TextureRef(path=tex_path, name=os.path.basename(tex_path)))
    return materials, textures


def _compute_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth normals."""
    normals = np.zeros_like(positions)
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    face_n = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(normals, tri[:, k], face_n)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def _compute_tangents(positions, normals, uvs, indices):
    """Per-vertex tangent/bitangent from UV gradients (Lengyel's method)."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    bit = np.zeros((v, 3), np.float64)
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    u0, u1, u2 = uvs[tri[:, 0]], uvs[tri[:, 1]], uvs[tri[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = u1 - u0, u2 - u0
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))[:, None]
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r
    b = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r
    for k in range(3):
        np.add.at(tan, tri[:, k], t)
        np.add.at(bit, tri[:, k], b)
    # Gram-Schmidt against the normal
    tan = tan - normals * np.sum(tan * normals, axis=1, keepdims=True)
    t_len = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = np.where(t_len < 1e-8, np.array([1.0, 0.0, 0.0]), tan / np.maximum(t_len, 1e-12))
    b_len = np.linalg.norm(bit, axis=1, keepdims=True)
    bit = np.where(b_len < 1e-8, np.cross(normals, tan), bit / np.maximum(b_len, 1e-12))
    return tan.astype(np.float32), bit.astype(np.float32)


def load_obj(path: str) -> ModelData:
    """Wavefront OBJ with MTL; one Mesh per material group."""
    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    materials: Dict[str, Material] = {}
    textures: List[TextureRef] = []
    mat_order: List[str] = []
    # per-material face lists of (vi, ti, ni) triples
    groups: Dict[str, List[Tuple[int, int, int]]] = {}
    current_mat = ""
    base_dir = os.path.dirname(os.path.abspath(path))

    def resolve_index(i: int, count: int) -> int:
        return i - 1 if i > 0 else count + i

    with open(path, errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "mtllib" and len(parts) > 1:
                mats, texs = _parse_mtl(os.path.join(base_dir, " ".join(parts[1:])))
                # texture indices are local to each mtl file; re-base
                tex_base = len(textures)
                for m in mats.values():
                    if m.base_color_texture >= 0:
                        m.base_color_texture += tex_base
                textures.extend(texs)
                materials.update(mats)
            elif key == "usemtl" and len(parts) > 1:
                current_mat = parts[1]
                if current_mat not in groups:
                    groups[current_mat] = []
                    mat_order.append(current_mat)
            elif key == "f":
                if current_mat not in groups:
                    groups[current_mat] = []
                    mat_order.append(current_mat)
                corners = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve_index(int(comps[0]), len(positions))
                    ti = (resolve_index(int(comps[1]), len(uvs))
                          if len(comps) > 1 and comps[1] else -1)
                    ni = (resolve_index(int(comps[2]), len(normals))
                          if len(comps) > 2 and comps[2] else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    # OBJ is CCW-front; our raster convention (matching the
                    # reference's cube/sphere winding under the Y-flipped
                    # projection) needs the reverse order.
                    groups[current_mat].extend([corners[0], corners[k + 1], corners[k]])

    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    uv_arr = np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else np.zeros((0, 2), np.float32)
    nrm_arr = np.asarray(normals, np.float32).reshape(-1, 3) if normals else np.zeros((0, 3), np.float32)

    data = ModelData(textures=textures)
    mat_index_of: Dict[str, int] = {}
    for name in mat_order:
        mat = materials.get(name, Material(name=name or "default"))
        mat_index_of[name] = len(data.materials)
        data.materials.append(mat)
    if not data.materials:
        data.materials.append(Material(name="default"))

    for name in mat_order:
        triples = groups[name]
        if not triples:
            continue
        # weld identical (v,t,n) triples
        welded: Dict[Tuple[int, int, int], int] = {}
        indices = np.empty(len(triples), np.int32)
        order: List[Tuple[int, int, int]] = []
        for i, tr in enumerate(triples):
            idx = welded.get(tr)
            if idx is None:
                idx = len(order)
                welded[tr] = idx
                order.append(tr)
            indices[i] = idx
        vi = np.array([t[0] for t in order], np.int64)
        v_pos = pos_arr[vi]
        v_uv = np.zeros((len(order), 2), np.float32)
        has_uv = np.array([t[1] >= 0 for t in order])
        if uv_arr.shape[0]:
            ti = np.array([t[1] if t[1] >= 0 else 0 for t in order], np.int64)
            v_uv = np.where(has_uv[:, None], uv_arr[ti], 0.0).astype(np.float32)
            v_uv[:, 1] = np.where(has_uv, 1.0 - v_uv[:, 1], 0.0)  # flip V (GL→Vulkan image rows)
        if nrm_arr.shape[0] and all(t[2] >= 0 for t in order):
            ni = np.array([t[2] for t in order], np.int64)
            v_nrm = nrm_arr[ni]
            norm = np.linalg.norm(v_nrm, axis=1, keepdims=True)
            v_nrm = (v_nrm / np.maximum(norm, 1e-12)).astype(np.float32)
        else:
            v_nrm = _compute_normals(v_pos, indices)
        tan, bit = _compute_tangents(v_pos, v_nrm, v_uv, indices)
        data.meshes.append(Mesh(
            v_pos, indices, normals=v_nrm, tangents=tan, bitangents=bit,
            uvs=v_uv, material_index=mat_index_of[name],
            name=name or os.path.basename(path)))
        data.instance_transforms.append(np.eye(4, dtype=np.float32))

    logger.info("loaded OBJ %s: %d meshes, %d materials, %d textures, %d tris",
                path, len(data.meshes), len(data.materials), len(data.textures),
                sum(m.triangle_count for m in data.meshes))
    return data
