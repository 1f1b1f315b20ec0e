"""Image IO without PIL: procedural textures and image decoders.

The port's own copy of `checkerboard` from trident_tpu/io/image.py, and
PIL-free counterparts of its loaders and writer: `decode_rgba` (embedded
images), `load_rgba8` and `load_rgba8_mips` (texture files), `save_png`.
The JAX package decodes raster formats through PIL; the port reads and
writes PNG itself with the standard library's zlib (it reads
non-interlaced grey, grey + alpha, palette, RGB and RGBA; 8-bit, and
1/2/4-bit grey and palette). Like the JAX loaders, `load_rgba8`
and `load_rgba8_mips` hand .ktx2 containers to assets/ktx2.py (with their
file mip chains) and .svg files to io/svg.py. Every other format (JPEG,
BMP, TGA, interlaced or 16-bit PNG) is refused: `load_rgba8` raises
ValueError naming it, `decode_rgba` returns None with the JAX function's
warning. `read_png` reads the repo's golden images.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from trident_tpu_torch.core.log import get_logger

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def checkerboard(size: int = 64, cells: int = 8,
                 color_a=(255, 255, 255, 255), color_b=(40, 40, 40, 255)) -> np.ndarray:
    """Procedural test texture."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell) + (y // cell)) % 2 == 0
    out = np.where(mask[..., None], np.array(color_a, np.uint8), np.array(color_b, np.uint8))
    return out.astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG scanline filters undone: rows (H, 1 + W·bpp) u8, filter byte
    first → (H, W·bpp) u8. Sub and Up are vectorized; Average and Paeth
    walk the row a pixel at a time."""
    h = rows.shape[0]
    out = np.zeros((h, rows.shape[1] - 1), np.int32)
    prior = np.zeros(rows.shape[1] - 1, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).ravel() & 0xFF
        elif kind == 2:
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, cur.shape[0], bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - up_left))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
                left, up_left = cur[x:x + bpp], up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = prior = cur
    return out.astype(np.uint8)


def _decode_png(data: bytes, name) -> np.ndarray:
    """(H, W, 4) uint8 of the bytes of a non-interlaced PNG of colour type
    0 (grey, 1/2/4/8-bit), 2 (RGB), 3 (palette, 1/2/4/8-bit), 4 (grey +
    alpha) or 6 (RGBA), the last three 8-bit; alpha from the tRNS chunk
    where there is one, else 255. Raises ValueError on anything else;
    `name` labels the messages."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    palette, trns = None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(colour)
    depths = (1, 2, 4, 8) if colour in (0, 3) else (8,)
    if channels is None or depth not in depths or interlace:
        raise ValueError(f"{name}: not read: depth {depth}, colour type "
                         f"{colour}, interlace {interlace} (8-bit samples, "
                         f"or 1/2/4-bit grey and palette, non-interlaced)")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    row_bytes = (w * channels * depth + 7) // 8
    rows = _unfilter(raw.reshape(h, 1 + row_bytes), max(1, channels * depth // 8))
    if depth < 8:           # packed samples, most significant bits first
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        img = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[..., None]
    else:
        img = rows.reshape(h, w, channels)
    if colour == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index outside its "
                             f"{len(palette)}-entry PLTE")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = trns[:len(palette)]
        rgba = np.concatenate([palette, alpha[:, None]], -1)
        return rgba[img[..., 0]]
    opaque = None
    if trns is not None and colour in (0, 2):
        # tRNS names one transparent grey or RGB value (16-bit samples)
        key = np.frombuffer(trns, ">u2")
        opaque = (img != key).any(-1)
    if depth < 8:           # grey scaled to 8 bits
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if colour in (0, 4):
        img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]],
                             -1)
    if img.shape[-1] == 3:
        alpha = np.full((h, w, 1), 255, np.uint8)
        if opaque is not None:
            alpha[..., 0] = np.where(opaque, 255, 0)
        img = np.concatenate([img, alpha], -1)
    return img


def save_png(path, rgba: np.ndarray) -> None:
    """Write an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) image as an 8-bit
    PNG (grey, RGB or RGBA; filter 0 on every row, zlib). Floats are
    taken as [0, 1] and rounded to bytes, as the JAX package's save_png
    does; it writes through PIL, the port with zlib alone."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba))


def encode_png(rgba: np.ndarray) -> bytes:
    """save_png's file as bytes."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        rgba = np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)
    img = rgba if rgba.ndim == 3 else rgba[..., None]
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """(H, W, 4) uint8 of an 8-bit, non-interlaced PNG file (_decode_png).
    Raises ValueError on anything else."""
    with open(path, "rb") as f:
        return _decode_png(f.read(), path)


def decode_rgba(blob: bytes) -> Optional[np.ndarray]:
    """Bytes of an embedded image (glTF data URIs and GLB views) →
    (H, W, 4) uint8, or None with a warning when the port cannot decode
    them (a corrupt payload, or any format but PNG), as the JAX function
    returns None on a payload PIL cannot read."""
    try:
        return _decode_png(bytes(blob), "embedded image")
    except Exception as exc:
        get_logger("io.image").warning("embedded image decode failed: %s",
                                       exc)
        return None


def load_rgba8(path: str) -> np.ndarray:
    """A texture file → (H, W, 4) uint8: .ktx2 (level 0, assets/ktx2.py),
    .svg (rasterized at its declared size, io/svg.py) or PNG; any other
    file raises ValueError naming its format."""
    lower = path.lower()
    if lower.endswith(".ktx2"):
        from trident_tpu_torch.assets.ktx2 import load_ktx2_rgba8

        return load_ktx2_rgba8(path)
    if lower.endswith(".svg"):
        from trident_tpu_torch.io.svg import rasterize_svg_file

        return rasterize_svg_file(path)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        ext = os.path.splitext(path)[1].lower() or "(no extension)"
        raise ValueError(f"{path}: cannot decode {ext} images: the port "
                         "reads PNG, KTX2 and SVG textures only")
    return _decode_png(data, path)


def load_rgba8_mips(path: str):
    """(rgba, mips-or-None): load_rgba8's image, and for a .ktx2 with more
    than one level its level 1.. images (the file's own mip chain)."""
    if path.lower().endswith(".ktx2"):
        from trident_tpu_torch.assets.ktx2 import load_ktx2_rgba8_mips

        return load_ktx2_rgba8_mips(path)
    return load_rgba8(path), None
