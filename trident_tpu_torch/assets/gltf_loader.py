"""glTF 2.0 / GLB loader → ModelData (no external deps).

Covers what the reference gets from Assimp (Loader/ModelLoader.cpp): meshes
(POSITION/NORMAL/TEXCOORD_0/COLOR_0/JOINTS_0/WEIGHTS_0 + indices), PBR
materials (baseColor/metallic/roughness + baseColorTexture), the node
hierarchy → per-mesh instance transforms, skins (joint hierarchy +
inverseBindMatrices → Skeleton with ≤4 renormalized influences), and
animations (T/R/S channels, LINEAR/STEP, baked in seconds).

Conventions mapped to ours: quaternions xyzw→wxyz, CCW front-face flipped
to the engine winding, V texture coordinate kept (glTF V is top-down like
Vulkan). Skinned meshes ignore their node transform per the glTF spec.

The port's own copy of trident_tpu/assets/gltf_loader.py: the port imports
nothing of the JAX package. Embedded images decode through the
port's PIL-free io/image.py::decode_rgba (PNG only).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from trident_tpu_torch.anim.data import AnimationClip, Bone, Skeleton, TransformChannel, normalize_bone_name
from trident_tpu_torch.assets.model_loader import ModelData, TextureRef, _compute_normals, _compute_tangents
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.geometry.mesh import Material, Mesh

logger = get_logger("assets.gltf")

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin or b"")
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(doc: dict, buffers: List[bytes], index: int) -> np.ndarray:
    acc = doc["accessors"][index]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize

    if "bufferView" not in acc:
        out = np.zeros((count, n_comp), dtype)
    else:
        view = doc["bufferViews"][acc["bufferView"]]
        data = buffers[view["buffer"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", 0) or n_comp * itemsize
        if stride == n_comp * itemsize:
            out = np.frombuffer(data, dtype, count * n_comp, offset).reshape(count, n_comp)
        else:
            # interleaved view (the default layout of many exporters): one
            # vectorized byte-matrix slice instead of a Python loop of
            # count frombuffer calls (~1.5M calls on a 500k-vertex glb)
            nbytes = (count - 1) * stride + n_comp * itemsize if count else 0
            raw = np.frombuffer(data, np.uint8, nbytes, offset)
            rows = np.lib.stride_tricks.as_strided(
                raw, shape=(count, n_comp * itemsize), strides=(stride, 1))
            out = np.ascontiguousarray(rows).view(dtype).reshape(count, n_comp)
    out = np.array(out)  # writable copy

    # sparse substitution
    sparse = acc.get("sparse")
    if sparse:
        sidx = sparse["indices"]
        sval = sparse["values"]
        iview = doc["bufferViews"][sidx["bufferView"]]
        idt = _COMPONENT_DTYPES[sidx["componentType"]]
        ioff = iview.get("byteOffset", 0) + sidx.get("byteOffset", 0)
        indices = np.frombuffer(buffers[iview["buffer"]], idt, sparse["count"], ioff)
        vview = doc["bufferViews"][sval["bufferView"]]
        voff = vview.get("byteOffset", 0) + sval.get("byteOffset", 0)
        values = np.frombuffer(buffers[vview["buffer"]], dtype,
                               sparse["count"] * n_comp, voff).reshape(-1, n_comp)
        out[np.asarray(indices, np.int64)] = values

    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
        if info.min < 0:
            # glTF mandates max(c/maxval, -1.0) for signed types: the raw
            # minimum (-128/127) would otherwise leave range
            out = np.maximum(out, -1.0)
    return out


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    q = node.get("rotation", [0, 0, 0, 1])   # xyzw
    s = node.get("scale", [1, 1, 1])
    from trident_tpu_torch.mathx.quat import quat_to_mat3

    wxyz = np.array([q[3], q[0], q[1], q[2]], np.float32)
    m[:3, :3] = np.asarray(quat_to_mat3(wxyz)) * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


def load_gltf(path: str) -> ModelData:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin: Optional[bytes] = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            magic, _version, _length = struct.unpack("<III", f.read(12))
            if magic != 0x46546C67:
                raise ValueError(f"{path}: not a GLB file")
            doc = None
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                chunk_len, chunk_type = struct.unpack("<II", header)
                chunk = f.read(chunk_len)
                if chunk_type == 0x4E4F534A:      # 'JSON'
                    doc = json.loads(chunk)
                elif chunk_type == 0x004E4942:    # 'BIN'
                    glb_bin = chunk
            if doc is None:
                raise ValueError(f"{path}: GLB missing JSON chunk")
    else:
        with open(path) as f:
            doc = json.load(f)

    buffers = _load_buffers(doc, base_dir, glb_bin)
    data = ModelData()

    # -- textures (file, data-URI, or GLB bufferView images) --------------------
    from trident_tpu_torch.io.image import decode_rgba as _decode_image_bytes

    image_refs: List[Optional[TextureRef]] = []
    for ii, img in enumerate(doc.get("images", [])):
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            from urllib.parse import unquote

            p = os.path.normpath(os.path.join(base_dir, unquote(uri)))
            image_refs.append(TextureRef(path=p, name=os.path.basename(p)))
        elif uri:  # data URI
            rgba = _decode_image_bytes(base64.b64decode(uri.split(",", 1)[1]))
            image_refs.append(None if rgba is None else TextureRef(
                path=f"{path}#image{ii}", name=f"image{ii}", rgba=rgba))
        elif "bufferView" in img:  # GLB embedded
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            blob = buffers[view["buffer"]][off:off + view["byteLength"]]
            rgba = _decode_image_bytes(bytes(blob))
            image_refs.append(None if rgba is None else TextureRef(
                path=f"{path}#image{ii}", name=f"image{ii}", rgba=rgba))
        else:
            image_refs.append(None)
    tex_to_ref: Dict[int, int] = {}
    for ti, tex in enumerate(doc.get("textures", [])):
        src = tex.get("source", -1)
        if 0 <= src < len(image_refs) and image_refs[src] is not None:
            tex_to_ref[ti] = len(data.textures)
            data.textures.append(image_refs[src])

    # -- materials ----------------------------------------------------------------
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        m = Material(
            base_color=tuple(float(x) for x in base),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            name=mat.get("name", ""),
        )
        bct = pbr.get("baseColorTexture", {}).get("index", -1)
        if bct in tex_to_ref:
            m.base_color_texture = tex_to_ref[bct]
        data.materials.append(m)
    if not data.materials:
        data.materials.append(Material(name="default"))

    nodes = doc.get("nodes", [])

    # -- global node transforms ---------------------------------------------------
    parent_of = {}
    for i, node in enumerate(nodes):
        for c in node.get("children", []):
            parent_of[c] = i

    def global_matrix(i: int) -> np.ndarray:
        m = _node_local_matrix(nodes[i])
        p = parent_of.get(i)
        return m if p is None else global_matrix(p) @ m

    # -- skins → skeleton -----------------------------------------------------------
    skeleton: Optional[Skeleton] = None
    joint_remap: Dict[int, int] = {}   # node index → bone index
    skins = doc.get("skins", [])
    if skins:
        skin = skins[0]
        joints: List[int] = skin["joints"]
        inv_binds = (_read_accessor(doc, buffers, skin["inverseBindMatrices"])
                     .reshape(-1, 4, 4).transpose(0, 2, 1)  # column-major → row
                     if "inverseBindMatrices" in skin
                     else np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1)))
        skeleton = Skeleton(name=skin.get("name", "skin0"))
        joint_set = set(joints)

        def joint_parent(node_idx: int) -> int:
            p = parent_of.get(node_idx)
            while p is not None and p not in joint_set:
                p = parent_of.get(p)
            return joint_remap.get(p, -1) if p is not None else -1

        # joints must be added parents-first: sort by hierarchy depth
        def depth(n: int) -> int:
            d = 0
            p = parent_of.get(n)
            while p is not None:
                d += 1
                p = parent_of.get(p)
            return d

        order = sorted(range(len(joints)), key=lambda k: depth(joints[k]))
        for k in order:
            node_idx = joints[k]
            src_name = nodes[node_idx].get("name", f"joint{k}")
            bone = Bone(
                name=normalize_bone_name(src_name),
                source_name=src_name,
                parent=joint_parent(node_idx),
                local_bind=_node_local_matrix(nodes[node_idx]),
                inverse_bind=np.asarray(inv_binds[k], np.float32),
            )
            joint_remap[node_idx] = skeleton.add_bone(bone)
        data.skeleton = skeleton
        # vertex joint indices refer to positions in skin["joints"]
        joints_to_bone = np.array([joint_remap[j] for j in joints], np.int32)
    else:
        joints_to_bone = None

    # -- meshes (instanced by nodes) ------------------------------------------------
    mesh_instances: List[Tuple[int, np.ndarray, bool]] = []  # (mesh idx, xf, skinned)
    for i, node in enumerate(nodes):
        if "mesh" in node:
            skinned = "skin" in node
            xf = np.eye(4, dtype=np.float32) if skinned else global_matrix(i)
            mesh_instances.append((node["mesh"], xf, skinned))
    if not mesh_instances:  # un-instanced meshes
        mesh_instances = [(i, np.eye(4, dtype=np.float32), False)
                          for i in range(len(doc.get("meshes", [])))]

    for mesh_idx, xf, _sk in mesh_instances:
        gmesh = doc["meshes"][mesh_idx]
        for prim in gmesh.get("primitives", []):
            if prim.get("mode", 4) != 4:   # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            count = pos.shape[0]
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.int32)
            else:
                idx = np.arange(count, dtype=np.int32)
            tri = idx.reshape(-1, 3)[:, ::-1].reshape(-1)   # flip winding to ours

            nrm = (_read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else _compute_normals(pos, tri))
            uv = (_read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((count, 2), np.float32))
            col = (_read_accessor(doc, buffers, attrs["COLOR_0"]).astype(np.float32)[:, :3]
                   if "COLOR_0" in attrs else None)
            tan, bit = _compute_tangents(pos, nrm, uv, tri)

            bone_idx = None
            bone_w = None
            if "JOINTS_0" in attrs and "WEIGHTS_0" in attrs and joints_to_bone is not None:
                j = _read_accessor(doc, buffers, attrs["JOINTS_0"]).astype(np.int64)
                w = _read_accessor(doc, buffers, attrs["WEIGHTS_0"]).astype(np.float32)
                wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
                bone_w = w / wsum                       # renormalize ≤4 influences
                bone_idx = joints_to_bone[np.clip(j, 0, len(joints_to_bone) - 1)]
                bone_idx = np.where(w > 0, bone_idx, -1).astype(np.int32)

            data.meshes.append(Mesh(
                pos, tri, normals=nrm, tangents=tan, bitangents=bit,
                colors=col, uvs=uv, bone_indices=bone_idx, bone_weights=bone_w,
                material_index=int(prim.get("material", 0)),
                name=gmesh.get("name", f"mesh{mesh_idx}")))
            data.instance_transforms.append(xf)

    # -- animations -------------------------------------------------------------------
    for anim in doc.get("animations", []):
        clip = AnimationClip(name=anim.get("name", f"clip{len(data.clips)}"),
                             duration=0.0)
        by_node: Dict[int, TransformChannel] = {}
        for channel in anim.get("channels", []):
            target = channel.get("target", {})
            node_idx = target.get("node")
            prop = target.get("path")
            if node_idx is None or prop not in ("translation", "rotation", "scale"):
                continue
            sampler = anim["samplers"][channel["sampler"]]
            times = _read_accessor(doc, buffers, sampler["input"]).reshape(-1).astype(np.float32)
            values = _read_accessor(doc, buffers, sampler["output"]).astype(np.float32)
            if sampler.get("interpolation", "LINEAR") == "CUBICSPLINE":
                values = values.reshape(len(times), 3, -1)[:, 1]  # keep the value row
            ch = by_node.get(node_idx)
            if ch is None:
                src_name = nodes[node_idx].get("name", f"node{node_idx}")
                ch = TransformChannel(bone_name=src_name)
                by_node[node_idx] = ch
            if prop == "translation":
                ch.position_times, ch.positions = times, values[:, :3]
            elif prop == "scale":
                ch.scale_times, ch.scales = times, values[:, :3]
            else:  # rotation xyzw → wxyz
                ch.rotation_times = times
                ch.rotations = values[:, [3, 0, 1, 2]]
            clip.duration = max(clip.duration, float(times[-1]) if len(times) else 0.0)
        clip.channels = list(by_node.values())
        data.clips.append(clip)

    logger.info("loaded glTF %s: %d meshes, %d materials, %d clips, skeleton=%s",
                path, len(data.meshes), len(data.materials), len(data.clips),
                None if data.skeleton is None else len(data.skeleton))
    return data
