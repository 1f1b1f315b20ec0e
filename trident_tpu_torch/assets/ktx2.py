"""Minimal KTX2 reader: uncompressed RGBA8/RGB8 payloads, 2D + cubemap,
zstd / zlib supercompression.

Reference: Loader/TextureLoader.cpp:417 loads KTX1+KTX2 through libktx
(ktxTexture2_CreateFromNamedFile) and binds the level images. Here the
container is parsed directly — the engine only ever consumes RGBA8 level
images (render/textures.py builds its own mip pyramids), so only the
formats the reference's own asset set uses are implemented; BasisLZ
transcoding is rejected with a clear error.

The port's own copy of trident_tpu/assets/ktx2.py (only the docstring
differs). Scheme 2 (zstd) imports `zstandard` when a payload needs it:
without that package it raises ImportError, as the JAX module does.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"

# VkFormat values (vulkan_core.h)
_VK_R8G8B8_UNORM = 23
_VK_R8G8B8_SRGB = 29
_VK_R8G8B8A8_UNORM = 37
_VK_R8G8B8A8_SRGB = 43
_CHANNELS = {
    _VK_R8G8B8_UNORM: 3,
    _VK_R8G8B8_SRGB: 3,
    _VK_R8G8B8A8_UNORM: 4,
    _VK_R8G8B8A8_SRGB: 4,
}


class Ktx2File:
    """Parsed header + decompressed level-0 images."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        if data[:12] != _KTX2_MAGIC:
            raise ValueError(f"{path}: not a KTX2 file")
        (vk_format, _type_size, width, height, _depth, layer_count,
         face_count, level_count, scheme) = struct.unpack("<9I", data[12:48])
        if vk_format not in _CHANNELS:
            if scheme == 1 or vk_format == 0:
                raise ValueError(
                    f"{path}: BasisLZ/UASTC KTX2 needs transcoding — "
                    "re-export as uncompressed RGBA8")
            raise ValueError(f"{path}: unsupported vkFormat {vk_format}")
        if scheme not in (0, 2, 3):
            raise ValueError(f"{path}: unsupported supercompression {scheme}")
        self.width, self.height = width, height
        self.channels = _CHANNELS[vk_format]
        self.srgb = vk_format in (_VK_R8G8B8_SRGB, _VK_R8G8B8A8_SRGB)
        self.faces = max(face_count, 1)
        self.layers = max(layer_count, 1)
        self.levels = max(level_count, 1)

        # index (after the 9 header words): dfd/kvd u32 pairs, sgd u64 pair,
        # then levelCount × (byteOffset, byteLength, uncompressedByteLength)
        off = 48 + 4 * 4 + 8 * 2
        self._level_index: List[Tuple[int, int, int]] = []
        for _ in range(self.levels):
            self._level_index.append(struct.unpack("<3Q", data[off:off + 24]))
            off += 24
        self._data = data
        self._scheme = scheme

    def level_bytes(self, level: int) -> bytes:
        byte_off, byte_len, uncomp_len = self._level_index[level]
        raw = self._data[byte_off:byte_off + byte_len]
        if self._scheme == 2:
            import zstandard

            raw = zstandard.ZstdDecompressor().decompress(
                raw, max_output_size=uncomp_len or 1 << 30)
        elif self._scheme == 3:
            import zlib

            raw = zlib.decompress(raw)
        return raw

    def level_images(self, level: int) -> np.ndarray:
        """(layers·faces, H>>level, W>>level, channels) uint8 — KTX2 level
        images are tightly packed, ordered layer-major then face."""
        h = max(self.height >> level, 1)
        w = max(self.width >> level, 1)
        n = self.layers * self.faces
        raw = self.level_bytes(level)
        need = n * h * w * self.channels
        if len(raw) < need:
            raise ValueError(f"KTX2 level {level}: {len(raw)} bytes < {need}")
        return np.frombuffer(raw, np.uint8, need).reshape(
            n, h, w, self.channels)


def _to_rgba(img: np.ndarray, channels: int) -> np.ndarray:
    if channels == 3:
        img = np.concatenate(
            [img, np.full((*img.shape[:2], 1), 255, np.uint8)], axis=-1)
    return img


def load_ktx2_rgba8(path: str) -> np.ndarray:
    """Level-0 2D image as (H,W,4) uint8 (the TextureLoader contract —
    the engine builds its own mip pyramid)."""
    tex = Ktx2File(path)
    return _to_rgba(tex.level_images(0)[0], tex.channels)


def load_ktx2_rgba8_mips(path: str):
    """(level-0 (H,W,4) uint8, [level 1.. images] or None) — the file's
    own mip chain, for slots that should use the author's filtered mips
    instead of the engine's box downsample (libktx mip-chain ingestion,
    TextureLoader.cpp:417)."""
    tex = Ktx2File(path)
    img0 = _to_rgba(tex.level_images(0)[0], tex.channels)
    if tex.levels <= 1:
        return img0, None
    mips = [_to_rgba(tex.level_images(l)[0], tex.channels)
            for l in range(1, tex.levels)]
    return img0, mips


def load_ktx2_cubemap(path: str) -> np.ndarray:
    """(6,H,W,3) f32 in [0,1], faces ordered +x,-x,+y,-y,+z,-z."""
    return load_ktx2_cubemap_mips(path)[0]


def load_ktx2_cubemap_mips(path: str) -> list:
    """All mip levels: [(6,E,E,3) f32, (6,E/2,E/2,3), ...] — the full file
    chain the reference uploads (TextureLoader.cpp:417)."""
    tex = Ktx2File(path)
    if tex.faces != 6:
        raise ValueError(f"{path}: KTX2 has {tex.faces} faces, need 6")
    return [tex.level_images(lvl)[:6][..., :3].astype(np.float32) / 255.0
            for lvl in range(tex.levels)]


def write_ktx2(path: str, images: np.ndarray, cubemap: bool = False,
               scheme: int = 0, mips=None) -> None:
    """Write an uncompressed RGBA8 KTX2 (tests + asset tooling; scheme:
    0 = none, 2 = zstd, 3 = zlib). `mips`: optional list of level 1..
    image stacks (same layout as `images`, halved dims per level) written
    as a file mip chain. Levels are stored in index order (the level
    index carries explicit offsets, which is what the reader consumes)."""
    def pack_level(arr):
        imgs = np.asarray(arr, np.uint8)
        if imgs.ndim == 3:
            imgs = imgs[None]
        return imgs

    level_imgs = [pack_level(images)] + [pack_level(m) for m in (mips or [])]
    n, h, w, ch = level_imgs[0].shape
    vk_format = _VK_R8G8B8A8_UNORM if ch == 4 else _VK_R8G8B8_UNORM
    face_count = 6 if cubemap else 1
    if cubemap and n != 6:
        raise ValueError("cubemap needs 6 images")
    # a non-cubemap stack of N>1 images is an array texture: the header
    # must say so (layerCount=N) or readers compute 1 image per level and
    # silently drop the rest of the payload
    layer_count = 0 if cubemap or n == 1 else n

    def compress(payload: bytes) -> bytes:
        if scheme == 2:
            import zstandard

            return zstandard.ZstdCompressor().compress(payload)
        if scheme == 3:
            import zlib

            return zlib.compress(payload)
        return payload

    payloads = [li.tobytes() for li in level_imgs]
    comps = [compress(p) for p in payloads]

    header = _KTX2_MAGIC + struct.pack(
        "<9I", vk_format, 1, w, h, 0, layer_count, face_count,
        len(level_imgs), scheme)
    # index: no dfd/kvd/sgd blocks (offsets 0), then the level entries
    index = struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
    data_off = len(header) + len(index) + 24 * len(level_imgs)
    level_entries = b""
    cursor = data_off
    for comp, payload in zip(comps, payloads):
        level_entries += struct.pack("<3Q", cursor, len(comp), len(payload))
        cursor += len(comp)
    with open(path, "wb") as f:
        f.write(header + index + level_entries + b"".join(comps))
