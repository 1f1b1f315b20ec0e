"""Skybox cubemap loading.

Reference: Loader/TextureLoader.h:29-63 SkyboxTextureLoader — KTX/KTX2
cubemaps, EXR HDR faces, loose PNG faces discovered by px/nx/py/ny/pz/nz
tokens, and a solid-color fallback. Face order: +x,-x,+y,-y,+z,-z.

The port's own copy of trident_tpu/assets/skybox.py (only the imports
differ). Faces decode through the port's io/image.py::load_rgba8 (PNG,
KTX2, SVG); .exr faces through imageio, imported when one is read:
without it they raise the JAX module's ValueError, and load_skybox falls
back to the solid colour with a warning.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from trident_tpu_torch.core.log import get_logger

logger = get_logger("assets.skybox")

FACE_TOKENS = [
    ("px", "posx", "right", "+x"),
    ("nx", "negx", "left", "-x"),
    ("py", "posy", "top", "up", "+y"),
    ("ny", "negy", "bottom", "down", "-y"),
    ("pz", "posz", "front", "+z"),
    ("nz", "negz", "back", "-z"),
]


def solid_skybox(color=(0.1, 0.12, 0.18), edge: int = 4) -> np.ndarray:
    faces = np.empty((6, edge, edge, 3), np.float32)
    faces[:] = np.asarray(color, np.float32)
    return faces


def _load_face(path: str, edge: Optional[int]) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        img = _load_exr(path)
    else:
        from trident_tpu_torch.io.image import load_rgba8

        img = load_rgba8(path).astype(np.float32) / 255.0
    img = img[..., :3]
    if edge is not None and img.shape[:2] != (edge, edge):
        yi = (np.arange(edge) * img.shape[0] / edge).astype(np.int64)
        xi = (np.arange(edge) * img.shape[1] / edge).astype(np.int64)
        img = img[yi][:, xi]
    return np.asarray(img, np.float32)


def _load_exr(path: str) -> np.ndarray:
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(path), np.float32)
    except Exception as exc:
        raise ValueError(f"EXR load failed for {path}: {exc}") from exc


def load_faces(paths: List[str], edge: Optional[int] = None) -> np.ndarray:
    """Explicit six paths ordered +x,-x,+y,-y,+z,-z → (6,E,E,3) f32."""
    if len(paths) != 6:
        raise ValueError("need exactly 6 face paths")
    first = _load_face(paths[0], edge)
    edge = first.shape[0]
    faces = [first] + [_load_face(p, edge) for p in paths[1:]]
    return np.stack(faces, axis=0)


def discover_faces(directory: str) -> Optional[List[str]]:
    """Find face files by px/nx/... name tokens (TextureLoader.h:45-63)."""
    try:
        files = sorted(os.listdir(directory))
    except OSError:
        return None
    found: List[Optional[str]] = [None] * 6
    for name in files:
        stem = os.path.splitext(name)[0].lower()
        for face_idx, tokens in enumerate(FACE_TOKENS):
            if found[face_idx] is None and any(
                    stem == t or stem.endswith("_" + t) or stem.endswith(t)
                    for t in tokens):
                found[face_idx] = os.path.join(directory, name)
                break
    if all(found):
        return found  # type: ignore[return-value]
    return None


def load_skybox(source: str, edge: Optional[int] = None,
                fallback_color=(0.1, 0.12, 0.18)) -> np.ndarray:
    """Load a cubemap from a directory of faces or a .ktx file; solid-color
    fallback on failure (like the reference). Base level only — use
    load_skybox_mips to get a KTX file's full mip chain."""
    return load_skybox_mips(source, edge, fallback_color)[0]


def load_skybox_mips(source: str, edge: Optional[int] = None,
                     fallback_color=(0.1, 0.12, 0.18)) -> list:
    """Like load_skybox but returns ALL mip levels a KTX1/KTX2 file
    carries ([base] for directories/fallbacks) — pass to
    Renderer.set_skybox(levels[0], mips=levels[1:]) for resolution-matched
    sampling (the reference uploads full chains, TextureLoader.cpp:417)."""
    try:
        if os.path.isdir(source):
            paths = discover_faces(source)
            if paths is None:
                raise ValueError(f"no px/nx/py/ny/pz/nz faces in {source}")
            return [load_faces(paths, edge)]
        if source.lower().endswith(".ktx"):
            return load_ktx1_cubemap_mips(source)
        if source.lower().endswith(".ktx2"):
            from trident_tpu_torch.assets.ktx2 import load_ktx2_cubemap_mips

            return load_ktx2_cubemap_mips(source)
        raise ValueError(f"unsupported skybox source: {source}")
    except Exception as exc:
        logger.warning("skybox load failed (%s): %s — using solid fallback",
                       source, exc)
        return [solid_skybox(fallback_color)]


# -- minimal KTX1 reader (uncompressed RGBA8 cubemaps) ---------------------------

_KTX1_MAGIC = b"\xabKTX 11\xbb\r\n\x1a\n"
_GL_RGBA = 0x1908
_GL_RGB = 0x1907
_GL_UNSIGNED_BYTE = 0x1401


def load_ktx1_cubemap_mips(path: str) -> list:
    """All mip levels: [(6,E,E,3) f32, (6,E/2,E/2,3), ...] — the full file
    chain the reference uploads (TextureLoader.cpp:417)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:12] != _KTX1_MAGIC:
        raise ValueError("not a KTX1 file")
    endian = "<" if struct.unpack("<I", data[12:16])[0] == 0x04030201 else ">"
    fields = struct.unpack(endian + "12I", data[16:64])
    (gl_type, _type_size, gl_format, _internal, _base_internal,
     width, height, _depth, _array_len, faces, mips, kv_bytes) = fields
    if faces != 6:
        raise ValueError(f"KTX has {faces} faces, need 6")
    if gl_type != _GL_UNSIGNED_BYTE or gl_format not in (_GL_RGBA, _GL_RGB):
        raise ValueError("only uncompressed RGB(A)8 KTX1 supported")
    channels = 4 if gl_format == _GL_RGBA else 3
    offset = 64 + kv_bytes
    levels = []
    w, h = width, height
    for _lvl in range(max(mips, 1)):
        image_size = struct.unpack(endian + "I", data[offset:offset + 4])[0]
        offset += 4
        face_size = w * h * channels
        if image_size not in (face_size, face_size * 6):
            raise ValueError("unexpected KTX image size")
        out = np.empty((6, h, w, 3), np.float32)
        for i in range(6):
            face = np.frombuffer(data, np.uint8, face_size, offset).reshape(
                h, w, channels)
            out[i] = face[..., :3].astype(np.float32) / 255.0
            offset += face_size
            offset += (3 - (face_size + 3) % 4)  # cube padding to 4 bytes
        levels.append(out)
        if w <= 1 and h <= 1:
            break
        w, h = max(w // 2, 1), max(h // 2, 1)
    return levels


def load_ktx1_cubemap(path: str) -> np.ndarray:
    return load_ktx1_cubemap_mips(path)[0]
