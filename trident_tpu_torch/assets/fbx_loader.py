"""Binary FBX loader: meshes, materials, textures, skins, animation clips.

The reference gets FBX for free through Assimp (reference:
Trident/src/Loader/ModelLoader.cpp:27-38 — triangulate, ≤4 bone weights,
Mixamo name normalization, clips in seconds). No Assimp here, so this is a
from-scratch reader of the FBX 7.x binary container (the format Mixamo and
every DCC exports):

  * node-record tree with typed properties; zlib-compressed arrays
  * Geometry → positions / polygon fan-triangulation / per-corner or
    per-vertex normals & UVs / per-polygon material assignment
  * Model transform chain T·Roff·Rp·Rpre·R·Rpost⁻¹·Rp⁻¹·Soff·Sp·S·Sp⁻¹
    (euler degrees, RotationOrder honoured)
  * Deformer Skin/Cluster → ≤4 influences per vertex, renormalized; the
    cluster `Transform` matrix is the inverse bind (bone-space ← mesh)
  * AnimationCurveNode/AnimationCurve → TRS channels baked at the union of
    curve key times (KTime ticks → seconds), quaternions from the full
    local-rotation chain so PreRotation is composed in, exactly like the
    reference's Assimp import

Output contract matches the other loaders (assets/model_loader.py
ModelData): shared-Vertex meshes with flipped V, reversed winding
(CCW-front source → the engine's raster convention), tangents, Morton
triangle order. Geometry is kept in file units (FBX is typically cm).

The port's own copy of trident_tpu/assets/fbx_loader.py. One addition:
a LayerElementColor layer (Colors / ColorIndex) becomes the mesh's vertex
colours (rgb; each welded vertex takes its first corner's colour, so the
weld, and every other field, is the JAX loader's), as the glTF loaders
read COLOR_0; the JAX loader drops the layer (white). Embedded textures
decode through the port's PIL-free io/image.py::decode_rgba (PNG only).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from trident_tpu_torch.anim.data import (
    AnimationClip,
    Bone,
    Skeleton,
    TransformChannel,
    normalize_bone_name,
)
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.geometry.mesh import Material, Mesh

logger = get_logger("assets.fbx")

_MAGIC = b"Kaydara FBX Binary  \x00"
KTIME_PER_SECOND = 46186158000.0


# -- container parsing ---------------------------------------------------------

@dataclass
class FbxNode:
    name: str
    props: List[object] = field(default_factory=list)
    children: List["FbxNode"] = field(default_factory=list)

    def child(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def prop(self, i: int, default=None):
        return self.props[i] if i < len(self.props) else default


_SCALARS = {b"Y": ("<h", 2), b"C": ("<B", 1), b"I": ("<i", 4),
            b"L": ("<q", 8), b"F": ("<f", 4), b"D": ("<d", 8)}
_ARRAYS = {b"f": np.float32, b"d": np.float64, b"l": np.int64,
           b"i": np.int32, b"b": np.uint8}


def _read_props(buf: bytes, pos: int, count: int) -> Tuple[List[object], int]:
    out: List[object] = []
    for _ in range(count):
        code = buf[pos:pos + 1]
        pos += 1
        if code in _SCALARS:
            fmt, size = _SCALARS[code]
            out.append(struct.unpack_from(fmt, buf, pos)[0])
            pos += size
        elif code in _ARRAYS:
            n, enc, comp_len = struct.unpack_from("<III", buf, pos)
            pos += 12
            dt = _ARRAYS[code]
            if enc == 1:
                raw = zlib.decompress(buf[pos:pos + comp_len])
            else:
                raw = buf[pos:pos + comp_len]
            pos += comp_len
            out.append(np.frombuffer(raw, dt, count=n))
        elif code in (b"S", b"R"):
            n = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            raw = buf[pos:pos + n]
            pos += n
            out.append(raw.decode("utf-8", "replace") if code == b"S" else raw)
        else:
            raise ValueError(f"unknown FBX property type {code!r} at {pos}")
    return out, pos


def _read_node(buf: bytes, pos: int, big: bool) -> Tuple[Optional[FbxNode], int]:
    if big:
        end, n_props, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, n_props, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    name_len = buf[pos]
    pos += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, pos  # null record: end of sibling list
    name = buf[pos:pos + name_len].decode("ascii", "replace")
    pos += name_len
    props, pos = _read_props(buf, pos, n_props)
    node = FbxNode(name=name, props=props)
    while pos < end:
        child, pos = _read_node(buf, pos, big)
        if child is None:
            break
        node.children.append(child)
    return node, end


def parse_fbx(buf: bytes) -> Tuple[FbxNode, int]:
    """Parse an FBX file → (virtual root node, version). Binary 7.x is the
    primary path; ASCII 7.x (the other format Assimp ingests via the same
    `.fbx` extension, ModelLoader.cpp:27-38) parses into the IDENTICAL
    node tree so every downstream consumer is shared."""
    if not buf.startswith(_MAGIC):
        head = buf[:4096]
        if b"FBXHeaderExtension" in head or head.lstrip()[:5] == b"; FBX":
            return _parse_fbx_ascii(buf.decode("utf-8", "replace"))
        raise ValueError("not an FBX file (neither the binary magic nor an "
                         "ASCII FBX header was found)")
    version = struct.unpack_from("<I", buf, 23)[0]
    big = version >= 7500
    pos = 27
    root = FbxNode(name="")
    while pos < len(buf):
        node, pos = _read_node(buf, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root, version


# -- ASCII container -----------------------------------------------------------

import re as _re

_ASCII_TOKEN = _re.compile(r"""
    "(?P<str>[^"]*)"                                  # quoted string
  | (?P<special>[+-]?1\.\#(?:INF|IND|QNAN|SNAN)\w*)   # MSVC printf specials
  | (?P<num>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | \*(?P<arr>\d+)                                    # *N array header
  | (?P<ident>[A-Za-z_][A-Za-z0-9_|\-]*)              # bare word
  | (?P<punct>[{}:,])
""", _re.VERBOSE | _re.IGNORECASE)


def _ascii_tokens(text: str):
    for line in text.splitlines():
        # comments: ';' outside quotes starts one (FBX ASCII convention)
        out, in_q = [], False
        for ch in line:
            if ch == '"':
                in_q = not in_q
            elif ch == ";" and not in_q:
                break
            out.append(ch)
        for m in _ASCII_TOKEN.finditer("".join(out)):
            yield m


def _ascii_value(m):
    if m.lastgroup == "str":
        s = m.group("str")
        # ASCII object names are "Class::Name"; the binary container (and
        # every consumer here) uses "Name\x00\x01Class" — normalize
        if "::" in s:
            cls, name = s.split("::", 1)
            return f"{name}\x00\x01{cls}"
        return s
    if m.lastgroup == "num":
        t = m.group("num")
        if any(c in t for c in ".eE"):
            return float(t)
        return int(t)
    if m.lastgroup == "special":
        # MSVC-printf non-finite literals (1.#INF / 1.#QNAN / -1.#IND):
        # without this pattern the tokenizer would split them into '1.'
        # + a stray ident, shifting every later array element. The float
        # sanitizers downstream then zero these like any other non-finite.
        t = m.group("special").upper()
        if "INF" in t:
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan")
    return m.group("ident")                   # bare words (T, W, Y, ...)


def _parse_fbx_ascii(text: str) -> Tuple[FbxNode, int]:
    toks = list(_ascii_tokens(text))
    pos = 0

    def peek(k=0):
        return toks[pos + k] if pos + k < len(toks) else None

    def tok_is(m, punct):
        return m is not None and m.lastgroup == "punct" and m.group() == punct

    def parse_nodes(depth):
        nonlocal pos
        nodes = []
        while True:
            m = peek()
            if m is None or tok_is(m, "}"):
                return nodes
            if m.lastgroup not in ("ident", "str") or not tok_is(peek(1), ":"):
                raise ValueError(
                    f"ASCII FBX: expected 'Name:' near token {m.group()!r}")
            name = m.group("str") if m.lastgroup == "str" else m.group("ident")
            pos += 2
            node = FbxNode(name=name)
            # array form: Name: *N { a: v,v,... }
            m = peek()
            if m is not None and m.lastgroup == "arr":
                pos += 1
                node.props.append(_parse_ascii_array())
            else:
                # prop list: value (, value)* — a bare word followed by ':'
                # is the NEXT sibling node, not a prop
                first = True
                while True:
                    m = peek()
                    if m is None or tok_is(m, "{") or tok_is(m, "}"):
                        break
                    if m.lastgroup in ("ident", "str") and tok_is(peek(1), ":"):
                        break
                    if not first:
                        if tok_is(m, ","):
                            pos += 1
                            m = peek()
                        else:
                            break
                    if m is None or m.lastgroup == "punct":
                        break
                    node.props.append(_ascii_value(m))
                    pos += 1
                    first = False
            m = peek()
            if tok_is(m, "{"):
                pos += 1
                node.children = parse_nodes(depth + 1)
                if not tok_is(peek(), "}"):
                    raise ValueError(f"ASCII FBX: unbalanced {{}} in {name}")
                pos += 1
            nodes.append(node)

    def _parse_ascii_array():
        nonlocal pos
        if not tok_is(peek(), "{"):
            raise ValueError("ASCII FBX: *N not followed by { a: ... }")
        pos += 1
        m = peek()
        if m is None or m.group() != "a" or not tok_is(peek(1), ":"):
            raise ValueError("ASCII FBX: array block missing 'a:'")
        pos += 2
        vals = []
        is_int = True
        while True:
            m = peek()
            if m is None or tok_is(m, "}"):
                break
            if tok_is(m, ","):
                pos += 1
                continue
            v = _ascii_value(m)
            if isinstance(v, float):
                is_int = False
            vals.append(v)
            pos += 1
        pos += 1                                       # consume '}'
        return np.asarray(vals, np.int64 if is_int else np.float64)

    root = FbxNode(name="")
    root.children = parse_nodes(0)
    version = 7400
    hdr = root.child("FBXHeaderExtension")
    if hdr is not None:
        v = hdr.child("FBXVersion")
        if v is not None and v.props:
            version = int(v.props[0])
    return root, version


# -- document model ------------------------------------------------------------

def _p70(node: FbxNode) -> Dict[str, List[object]]:
    """Properties70 → {prop name: raw value list (after the 4 header cols)}."""
    out: Dict[str, List[object]] = {}
    p70 = node.child("Properties70")
    if p70 is None:
        return out
    for p in p70.find_all("P"):
        if p.props:
            out[str(p.props[0])] = p.props[4:]
    return out


def _vec3(props: Dict[str, List[object]], key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if not v or len(v) < 3:
        return np.asarray(default, np.float64)
    return np.asarray([float(v[0]), float(v[1]), float(v[2])], np.float64)


def _euler_deg_to_mat(deg: np.ndarray, order: int) -> np.ndarray:
    """FBX euler (degrees) → 3×3. order: eEulerXYZ=0 … eSphericXYZ=6;
    letters are applied first-to-last, i.e. XYZ ⇒ R = Rz·Ry·Rx."""
    r = np.radians(deg.astype(np.float64))
    c, s = np.cos(r), np.sin(r)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    orders = {0: "xyz", 1: "xzy", 2: "yzx", 3: "yxz", 4: "zxy", 5: "zyx",
              6: "xyz"}
    seq = orders.get(order, "xyz")
    m = {"x": rx, "y": ry, "z": rz}
    out = np.eye(3)
    for axis in seq:          # apply first axis first: R = R3·R2·R1
        out = m[axis] @ out
    return out


def _trs(t: np.ndarray, r3: np.ndarray, s: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r3 * s[None, :]
    m[:3, 3] = t
    return m


@dataclass
class _Model:
    node: FbxNode
    name: str
    cls: str                          # "LimbNode", "Mesh", "Null", ...
    props: Dict[str, List[object]] = field(default_factory=dict)
    parent: int = 0                   # object id (0 = scene root)

    def rotation_chain(self, euler_deg: np.ndarray) -> np.ndarray:
        """Rpre · R(euler) · Rpost⁻¹ as 3×3."""
        order = int(self.props.get("RotationOrder", [0])[0]) \
            if "RotationOrder" in self.props else 0
        pre = _euler_deg_to_mat(_vec3(self.props, "PreRotation"), 0)
        post = _euler_deg_to_mat(_vec3(self.props, "PostRotation"), 0)
        return pre @ _euler_deg_to_mat(euler_deg, order) @ post.T

    def local_matrix(self, t=None, r=None, s=None) -> np.ndarray:
        """Local transform, optionally overriding animated Lcl TRS.
        T·Roff·Rp·Rpre·R·Rpost⁻¹·Rp⁻¹·Soff·Sp·S·Sp⁻¹."""
        p = self.props
        t = _vec3(p, "Lcl Translation") if t is None else np.asarray(t, np.float64)
        r = _vec3(p, "Lcl Rotation") if r is None else np.asarray(r, np.float64)
        s = (_vec3(p, "Lcl Scaling", (1, 1, 1)) if s is None
             else np.asarray(s, np.float64))
        roff = _vec3(p, "RotationOffset")
        rp = _vec3(p, "RotationPivot")
        soff = _vec3(p, "ScalingOffset")
        sp = _vec3(p, "ScalingPivot")
        rot = self.rotation_chain(r)
        m = np.eye(4)
        m[:3, 3] = t + roff + rp
        m[:3, :3] = rot
        m[:3, 3] += rot @ (-rp + soff + sp)
        scale = np.diag(np.concatenate([s, [1.0]]))
        shift = np.eye(4)
        shift[:3, 3] = -sp
        return (m @ scale @ shift).astype(np.float64)


def _split_name(raw: str) -> str:
    # object names are "Name\x00\x01Class"
    return raw.split("\x00", 1)[0]


class _Document:
    """Indexed object graph: objects by id + typed connection lists."""

    def __init__(self, root: FbxNode):
        self.objects: Dict[int, FbxNode] = {}
        self.oo_parents: Dict[int, List[int]] = {}      # child → parents
        self.oo_children: Dict[int, List[int]] = {}     # parent → children
        self.op_children: Dict[int, List[Tuple[int, str]]] = {}  # dst → (src, prop)
        self.op_parents: Dict[int, List[Tuple[int, str]]] = {}   # src → (dst, prop)
        objs = root.child("Objects")
        if objs is not None:
            for node in objs.children:
                if node.props and isinstance(node.props[0], int):
                    self.objects[int(node.props[0])] = node
        conns = root.child("Connections")
        if conns is not None:
            for c in conns.find_all("C"):
                kind = str(c.prop(0, ""))
                src, dst = int(c.prop(1, 0)), int(c.prop(2, 0))
                if kind == "OO":
                    self.oo_parents.setdefault(src, []).append(dst)
                    self.oo_children.setdefault(dst, []).append(src)
                elif kind == "OP":
                    prop = str(c.prop(3, ""))
                    self.op_children.setdefault(dst, []).append((src, prop))
                    self.op_parents.setdefault(src, []).append((dst, prop))

    def children_of(self, oid: int, name: str) -> List[int]:
        return [c for c in self.oo_children.get(oid, [])
                if c in self.objects and self.objects[c].name == name]


# -- geometry ------------------------------------------------------------------

def _layer_values(geom: FbxNode, layer_name: str, value_name: str,
                  index_name: str, n_corners: int, n_vertices: int,
                  poly_vtx: np.ndarray, width: int) -> Optional[np.ndarray]:
    """Resolve a LayerElement to per-CORNER values (n_corners, width)."""
    layer = geom.child(layer_name)
    if layer is None:
        return None
    values_node = layer.child(value_name)
    if values_node is None or not len(values_node.props):
        return None
    values = np.asarray(values_node.props[0], np.float64).reshape(-1, width)
    mapping = ""
    ref = "Direct"
    m = layer.child("MappingInformationType")
    if m is not None and m.props:
        mapping = str(m.props[0])
    r = layer.child("ReferenceInformationType")
    if r is not None and r.props:
        ref = str(r.props[0])
    idx = None
    idx_node = layer.child(index_name)
    if ref == "IndexToDirect" and idx_node is not None and len(idx_node.props):
        idx = np.asarray(idx_node.props[0], np.int64)

    def direct(count):
        if idx is not None:
            ii = idx[:count]
            safe = np.clip(ii, 0, max(values.shape[0] - 1, 0))
            out = values[np.where(ii >= 0, safe, 0)] \
                if values.shape[0] else np.zeros((0, width), np.float64)
        else:
            out = values[:count]
        if out.shape[0] < count:
            # truncated/hostile layer (fewer index or value rows than
            # corners): repeat the last row / zero-fill instead of letting
            # the later per-corner gather IndexError out of load_fbx —
            # consistent with the NaN/inf sanitization below
            pad = (np.zeros((count - out.shape[0], width), np.float64)
                   if out.shape[0] == 0
                   else np.repeat(out[-1:], count - out.shape[0], axis=0))
            out = np.concatenate([out, pad], axis=0)
        return out

    if mapping == "ByPolygonVertex":
        return direct(n_corners)
    if mapping in ("ByVertice", "ByVertex", "ByControlPoint"):
        per_vertex = direct(n_vertices)
        return per_vertex[poly_vtx]
    if mapping == "AllSame":
        return np.broadcast_to(values[0], (n_corners, width)).copy()
    logger.warning("unsupported FBX mapping %r for %s", mapping, layer_name)
    return None


def _material_of_corner(geom: FbxNode, n_polys: int) -> np.ndarray:
    layer = geom.child("LayerElementMaterial")
    if layer is None:
        return np.zeros(n_polys, np.int64)
    m = layer.child("MappingInformationType")
    mats_node = layer.child("Materials")
    if mats_node is None or not len(mats_node.props):
        return np.zeros(n_polys, np.int64)
    mats = np.asarray(mats_node.props[0], np.int64)
    if m is not None and m.props and str(m.props[0]) == "ByPolygon" \
            and mats.shape[0] >= n_polys:
        return mats[:n_polys]
    return np.full(n_polys, int(mats[0]) if mats.size else 0, np.int64)


def _triangulate(pvi: np.ndarray):
    """PolygonVertexIndex → (corner indices (K,3) into the flat corner list,
    polygon id per triangle). Negative index marks polygon end (XOR -1)."""
    tris: List[Tuple[int, int, int]] = []
    poly_of: List[int] = []
    start = 0
    poly = 0
    for i in range(pvi.shape[0]):
        if pvi[i] < 0:
            n = i - start + 1
            for k in range(1, n - 1):
                # reverse winding: source CCW-front → engine convention
                tris.append((start, start + k + 1, start + k))
                poly_of.append(poly)
            start = i + 1
            poly += 1
    return np.asarray(tris, np.int64).reshape(-1, 3), np.asarray(poly_of, np.int64)


# -- loader --------------------------------------------------------------------

def load_fbx(path: str):
    from trident_tpu_torch.assets.model_loader import ModelData, TextureRef
    from trident_tpu_torch.assets.model_loader import _compute_normals, _compute_tangents

    with open(path, "rb") as f:
        buf = f.read()
    root, version = parse_fbx(buf)
    doc = _Document(root)

    data = ModelData()

    # models (nodes): id → _Model; hierarchy from OO model→model connections
    models: Dict[int, _Model] = {}
    for oid, node in doc.objects.items():
        if node.name == "Model":
            m = _Model(node=node, name=_split_name(str(node.prop(1, ""))),
                       cls=str(node.prop(2, "")), props=_p70(node))
            for parent in doc.oo_parents.get(oid, []):
                if parent in doc.objects and doc.objects[parent].name == "Model":
                    m.parent = parent
                    break
            models[oid] = m

    def global_matrix(oid: int) -> np.ndarray:
        m = np.eye(4)
        seen = set()
        while oid in models and oid not in seen:
            seen.add(oid)
            m = models[oid].local_matrix() @ m
            oid = models[oid].parent
        return m

    # materials: keep first-seen order; map object id → material index
    mat_index: Dict[int, int] = {}
    tex_cache: Dict[int, int] = {}

    def _texture_for(mat_id: int) -> int:
        for src, prop in doc.op_children.get(mat_id, []):
            node = doc.objects.get(src)
            if node is None or node.name != "Texture" or prop != "DiffuseColor":
                continue
            if src in tex_cache:
                return tex_cache[src]
            rel = node.child("RelativeFilename")
            fn = node.child("FileName")
            tex_path = ""
            for cand in (rel, fn):
                if cand is not None and cand.props:
                    tex_path = str(cand.props[0]).replace("\\", "/")
                    if tex_path:
                        break
            rgba = None
            # embedded payload: the texture's Video object carries Content
            for vsrc in doc.oo_children.get(src, []):
                vnode = doc.objects.get(vsrc)
                if vnode is not None and vnode.name == "Video":
                    content = vnode.child("Content")
                    if content is not None and content.props and \
                            isinstance(content.props[0], (bytes, bytearray)) \
                            and len(content.props[0]):
                        from trident_tpu_torch.io.image import decode_rgba

                        # corrupt payload → None → path-only TextureRef
                        rgba = decode_rgba(bytes(content.props[0]))
            resolved = os.path.normpath(
                os.path.join(os.path.dirname(os.path.abspath(path)), tex_path))
            ref = TextureRef(path=resolved if tex_path else f"{path}#tex{src}",
                             name=os.path.basename(tex_path) or f"tex{src}",
                             rgba=rgba)
            tex_cache[src] = len(data.textures)
            data.textures.append(ref)
            return tex_cache[src]
        return -1

    def _material_index(mat_id: int) -> int:
        if mat_id in mat_index:
            return mat_index[mat_id]
        node = doc.objects.get(mat_id)
        mat = Material(name=_split_name(str(node.prop(1, "material")))
                       if node is not None else "material")
        if node is not None:
            p = _p70(node)
            dc = _vec3(p, "DiffuseColor", (1, 1, 1))
            mat.base_color = (float(dc[0]), float(dc[1]), float(dc[2]), 1.0)
            if "Shininess" in p:
                ns = float(p["Shininess"][0])
                mat.roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)),
                                              0.045, 1.0))
            mat.base_color_texture = _texture_for(mat_id)
        mat_index[mat_id] = len(data.materials)
        data.materials.append(mat)
        return mat_index[mat_id]

    # skeleton from LimbNode models (plus any model that clusters reference)
    skeleton = Skeleton(name=os.path.basename(path))
    bone_ids = [oid for oid, m in models.items()
                if m.cls in ("LimbNode", "Limb", "Root")]
    cluster_bones = set()
    for oid, node in doc.objects.items():
        if node.name == "Deformer" and str(node.prop(2, "")) == "Cluster":
            for b in doc.oo_children.get(oid, []):
                if b in models:
                    cluster_bones.add(b)
    bone_ids = list(dict.fromkeys(bone_ids + sorted(cluster_bones)))
    # parent-before-child order
    bone_set = set(bone_ids)
    ordered: List[int] = []

    def _add_chain(oid: int):
        if oid in ordered or oid not in bone_set:
            return
        if models[oid].parent in bone_set:
            _add_chain(models[oid].parent)
        ordered.append(oid)

    for oid in bone_ids:
        _add_chain(oid)
    bone_of_model: Dict[int, int] = {}
    for oid in ordered:
        m = models[oid]
        parent = bone_of_model.get(m.parent, -1)
        idx = skeleton.add_bone(Bone(
            name=normalize_bone_name(m.name), source_name=m.name,
            parent=parent,
            local_bind=m.local_matrix().astype(np.float32)))
        bone_of_model[oid] = idx

    # geometry: one FBX Geometry may split into several engine meshes
    # (per material); instanced via its parent Model's global transform
    for oid, node in doc.objects.items():
        if node.name != "Geometry" or str(node.prop(2, "")) != "Mesh":
            continue
        verts_node = node.child("Vertices")
        pvi_node = node.child("PolygonVertexIndex")
        if verts_node is None or pvi_node is None or not len(verts_node.props):
            continue
        positions = np.asarray(verts_node.props[0], np.float64).reshape(-1, 3)
        # sanitize hostile/corrupt coordinates: NaN/inf/huge values poison
        # downstream float32 casts and norm computations (fuzz-hardening)
        positions = np.nan_to_num(positions, nan=0.0, posinf=0.0,
                                  neginf=0.0).clip(-1e30, 1e30)
        pvi = np.asarray(pvi_node.props[0], np.int64)
        corner_vtx = np.where(pvi < 0, -pvi - 1, pvi)   # per-corner vertex id
        tris, poly_of = _triangulate(pvi)
        if tris.shape[0] == 0:
            continue
        n_corners, n_vertices = corner_vtx.shape[0], positions.shape[0]

        normals = _layer_values(node, "LayerElementNormal", "Normals",
                                "NormalsIndex", n_corners, n_vertices,
                                corner_vtx, 3)
        uvs = _layer_values(node, "LayerElementUV", "UV", "UVIndex",
                            n_corners, n_vertices, corner_vtx, 2)
        # hostile/corrupt files can carry NaN/inf/huge layer values; the
        # weld rounds these into int64 keys and casts to float32 (both
        # undefined for such inputs) — sanitize once here. Normals clamp
        # inside float32 range; UVs so that uv*1e6 fits int64.
        if normals is not None:
            # ±1e12 keeps normal*1e4 inside int64 for the weld keys (real
            # normals are unit-length; this only tames hostile junk)
            normals = np.nan_to_num(normals, nan=0.0, posinf=0.0,
                                    neginf=0.0).clip(-1e12, 1e12)
        if uvs is not None:
            uvs = np.nan_to_num(uvs, nan=0.0, posinf=0.0,
                                neginf=0.0).clip(-1e9, 1e9)
        colors = _layer_values(node, "LayerElementColor", "Colors",
                               "ColorIndex", n_corners, n_vertices,
                               corner_vtx, 4)
        if colors is not None:
            colors = np.nan_to_num(colors, nan=0.0, posinf=0.0,
                                   neginf=0.0).clip(-1e30, 1e30)
        poly_mat = _material_of_corner(node, int(poly_of.max()) + 1
                                       if poly_of.size else 1)

        # model instances: one Geometry OO-connected to N Models is FBX
        # instancing — every parent Model gets its own engine mesh entry
        # (the welded arrays are SHARED numpy objects; only the transform
        # and material binding differ per instance)
        parent_models = [p for p in doc.oo_parents.get(oid, [])
                         if p in models] or [None]

        # skin clusters → per-vertex ≤4 influences
        bone_idx = np.full((n_vertices, 4), -1, np.int32)
        bone_wgt = np.zeros((n_vertices, 4), np.float32)
        influence_count = np.zeros(n_vertices, np.int32)
        has_skin = False
        for skin_id in doc.children_of(oid, "Deformer"):
            for cl_id in doc.children_of(skin_id, "Deformer"):
                cl = doc.objects[cl_id]
                if str(cl.prop(2, "")) != "Cluster":
                    continue
                idxs_n, wgts_n = cl.child("Indexes"), cl.child("Weights")
                if idxs_n is None or wgts_n is None or not len(idxs_n.props):
                    continue
                bmodel = next((b for b in doc.oo_children.get(cl_id, [])
                               if b in bone_of_model), None)
                if bmodel is None:
                    continue
                b = bone_of_model[bmodel]
                tr = cl.child("Transform")
                if tr is not None and tr.props and len(tr.props[0]) == 16:
                    # column-major in file; our Bone stores row-major M
                    skeleton.bones[b].inverse_bind = np.asarray(
                        tr.props[0], np.float64).reshape(4, 4).T.astype(np.float32)
                has_skin = True
                for vi, w in zip(np.asarray(idxs_n.props[0], np.int64),
                                 np.asarray(wgts_n.props[0], np.float64)):
                    if not (0 <= vi < n_vertices) or w <= 0:
                        continue
                    slot = influence_count[vi]
                    if slot < 4:
                        bone_idx[vi, slot] = b
                        bone_wgt[vi, slot] = w
                        influence_count[vi] += 1
                    else:  # keep the 4 largest
                        smallest = int(np.argmin(bone_wgt[vi]))
                        if w > bone_wgt[vi, smallest]:
                            bone_idx[vi, smallest] = b
                            bone_wgt[vi, smallest] = w
        if has_skin:
            total = bone_wgt.sum(axis=1, keepdims=True)
            bone_wgt = np.where(total > 1e-8, bone_wgt / np.maximum(total, 1e-8),
                                bone_wgt).astype(np.float32)

        # split triangles by material slot and weld (vertex, uv, normal) corners
        tri_mat = poly_mat[poly_of] if poly_mat.size else np.zeros(
            tris.shape[0], np.int64)
        for slot_id in np.unique(tri_mat):
            sel = tris[tri_mat == slot_id]               # (K,3) corner ids
            corners = sel.reshape(-1)
            key_cols = [corner_vtx[corners][:, None]]
            if uvs is not None:
                key_cols.append(np.round(uvs[corners] * 1e6).astype(np.int64))
            if normals is not None:
                key_cols.append(np.round(normals[corners] * 1e4).astype(np.int64))
            keys = np.concatenate(key_cols, axis=1)
            uniq, first, inverse = np.unique(
                keys, axis=0, return_index=True, return_inverse=True)
            v_src = corner_vtx[corners][first]
            v_pos = positions[v_src].astype(np.float32)
            v_uv = (uvs[corners][first].astype(np.float32)
                    if uvs is not None else np.zeros((uniq.shape[0], 2),
                                                     np.float32))
            if uvs is not None:
                v_uv[:, 1] = 1.0 - v_uv[:, 1]            # flip V (image rows)
            indices = inverse.astype(np.int32)
            if normals is not None:
                v_nrm = normals[corners][first].astype(np.float32)
                n = np.linalg.norm(v_nrm, axis=1, keepdims=True)
                v_nrm = (v_nrm / np.maximum(n, 1e-12)).astype(np.float32)
            else:
                v_nrm = _compute_normals(v_pos, indices)
            v_col = (colors[corners][first][:, :3].astype(np.float32)
                     if colors is not None else None)
            tan, bit = _compute_tangents(v_pos, v_nrm, v_uv, indices)
            slot_i = int(slot_id)
            for model_oid in parent_models:
                inst = (global_matrix(model_oid) if model_oid is not None
                        else np.eye(4)).astype(np.float32)
                mat_ids = ([c for c in doc.oo_children.get(model_oid, [])
                            if c in doc.objects
                            and doc.objects[c].name == "Material"]
                           if model_oid is not None else [])
                mat_id = mat_ids[slot_i] if 0 <= slot_i < len(mat_ids) else (
                    mat_ids[0] if mat_ids else -1)
                mindex = _material_index(mat_id) if mat_id >= 0 else 0
                if not data.materials:
                    data.materials.append(Material(name="default"))
                data.meshes.append(Mesh(
                    v_pos, indices, normals=v_nrm, tangents=tan,
                    bitangents=bit, colors=v_col, uvs=v_uv,
                    bone_indices=bone_idx[v_src] if has_skin else None,
                    bone_weights=bone_wgt[v_src] if has_skin else None,
                    material_index=mindex,
                    name=_split_name(str(node.prop(1, "")))
                    or os.path.basename(path)))
                data.instance_transforms.append(inst)

    if not data.materials:
        data.materials.append(Material(name="default"))
    if len(skeleton):
        data.skeleton = skeleton

    data.clips.extend(_load_clips(doc, models, bone_of_model))

    logger.info("loaded FBX %s (v%d): %d meshes, %d materials, %d bones, "
                "%d clips, %d tris", path, version, len(data.meshes),
                len(data.materials), len(skeleton), len(data.clips),
                sum(m.triangle_count for m in data.meshes))
    return data


# -- animation -----------------------------------------------------------------

def _curves_of(doc: _Document, curve_node_id: int) -> Dict[str, FbxNode]:
    out: Dict[str, FbxNode] = {}
    for src, prop in doc.op_children.get(curve_node_id, []):
        node = doc.objects.get(src)
        if node is not None and node.name == "AnimationCurve":
            out[prop] = node
    return out


def _sample_curve(curve: Optional[FbxNode], times: np.ndarray,
                  default: float) -> np.ndarray:
    if curve is None:
        return np.full(times.shape, default, np.float64)
    kt = curve.child("KeyTime")
    kv = curve.child("KeyValueFloat")
    if kt is None or kv is None or not len(kt.props) or not len(kv.props):
        return np.full(times.shape, default, np.float64)
    t = np.asarray(kt.props[0], np.float64) / KTIME_PER_SECOND
    v = np.asarray(kv.props[0], np.float64)
    if t.size == 0:
        return np.full(times.shape, default, np.float64)
    return np.interp(times, t, v)


def _mat3_to_quat_wxyz(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _load_clips(doc: _Document, models: Dict[int, _Model],
                bone_of_model: Dict[int, int]) -> List[AnimationClip]:
    clips: List[AnimationClip] = []
    for stack_id, stack in doc.objects.items():
        if stack.name != "AnimationStack":
            continue
        layer_ids = [c for c in doc.oo_children.get(stack_id, [])
                     if c in doc.objects
                     and doc.objects[c].name == "AnimationLayer"]
        # model id → {"T"/"R"/"S": curve-node id}
        targets: Dict[int, Dict[str, int]] = {}
        for layer_id in layer_ids:
            for cn_id in doc.oo_children.get(layer_id, []):
                cn = doc.objects.get(cn_id)
                if cn is None or cn.name != "AnimationCurveNode":
                    continue
                for dst, prop in doc.op_parents.get(cn_id, []):
                    if dst not in models:
                        continue
                    kind = {"Lcl Translation": "T", "Lcl Rotation": "R",
                            "Lcl Scaling": "S"}.get(prop)
                    if kind:
                        targets.setdefault(dst, {})[kind] = cn_id
        if not targets:
            continue
        clip = AnimationClip(
            name=_split_name(str(stack.prop(1, f"clip{len(clips)}"))),
            duration=0.0)
        for model_id, kinds in targets.items():
            if bone_of_model and model_id not in bone_of_model:
                # camera/light/mesh-node tracks: the runtime samples BONE
                # channels only (AnimationClip.channel_for), and a longer
                # non-bone key range would inflate clip.duration past the
                # skeletal animation (loops would freeze in the end pose)
                continue
            model = models[model_id]
            # union of key times across this bone's curves
            all_t: List[np.ndarray] = []
            curves: Dict[str, Dict[str, FbxNode]] = {}
            for kind, cn_id in kinds.items():
                curves[kind] = _curves_of(doc, cn_id)
                for c in curves[kind].values():
                    kt = c.child("KeyTime")
                    if kt is not None and len(kt.props):
                        all_t.append(np.asarray(kt.props[0], np.float64)
                                     / KTIME_PER_SECOND)
            if not all_t:
                continue
            times = np.unique(np.concatenate(all_t))
            p = model.props
            dt = _vec3(p, "Lcl Translation")
            dr = _vec3(p, "Lcl Rotation")
            ds = _vec3(p, "Lcl Scaling", (1, 1, 1))

            def axes(kind, defaults):
                cs = curves.get(kind, {})
                return np.stack([
                    _sample_curve(cs.get("d|X"), times, defaults[0]),
                    _sample_curve(cs.get("d|Y"), times, defaults[1]),
                    _sample_curve(cs.get("d|Z"), times, defaults[2])], axis=1)

            tv = axes("T", dt) if "T" in kinds else np.tile(dt, (len(times), 1))
            rv = axes("R", dr) if "R" in kinds else np.tile(dr, (len(times), 1))
            sv = axes("S", ds) if "S" in kinds else np.tile(ds, (len(times), 1))
            rots = [model.rotation_chain(rv[k]) for k in range(len(times))]
            # bake the full pivot/offset chain into the stored translation
            # so the runtime's plain T·R·S compose (anim/pose.py) equals
            # local_matrix(): trans = t + roff + rp + R·(−rp+soff+sp−s·sp)
            # (the linear part R·diag(s) already IS the stored R,S)
            roff, rp = _vec3(p, "RotationOffset"), _vec3(p, "RotationPivot")
            soff, sp = _vec3(p, "ScalingOffset"), _vec3(p, "ScalingPivot")
            if np.any(roff) or np.any(rp) or np.any(soff) or np.any(sp):
                tv = np.stack([
                    tv[k] + roff + rp
                    + rots[k] @ (-rp + soff + sp - sv[k] * sp)
                    for k in range(len(times))], axis=0)
            quats = np.stack([_mat3_to_quat_wxyz(m) for m in rots], axis=0)
            # enforce quaternion continuity for slerp
            for k in range(1, quats.shape[0]):
                if np.dot(quats[k], quats[k - 1]) < 0:
                    quats[k] = -quats[k]
            ch = TransformChannel(
                bone_name=model.name,
                position_times=times.astype(np.float32),
                positions=tv.astype(np.float32),
                rotation_times=times.astype(np.float32),
                rotations=quats.astype(np.float32),
                scale_times=times.astype(np.float32),
                scales=sv.astype(np.float32))
            clip.channels.append(ch)
            clip.duration = max(clip.duration, float(times[-1]))
        if clip.channels:
            clips.append(clip)
    return clips
