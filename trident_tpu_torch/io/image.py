"""Procedural textures and the PNG reader.

The port's own copy of `checkerboard` from trident_tpu/io/image.py (the
PIL-backed loaders stay in the JAX package): the port imports nothing of
the JAX package. `read_png` decodes the 8-bit, non-interlaced RGB(A) PNGs
the repo's golden images are, with the standard library's zlib alone, so
that a machine without PIL can hold a frame against them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

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


def read_png(path) -> np.ndarray:
    """(H, W, 4) uint8 of an 8-bit, non-interlaced RGBA or RGB PNG (RGB
    gets alpha 255). Raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    channels = {6: 4, 2: 3}.get(colour)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB(A) PNGs are "
                         f"read (depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(h, 1 + w * channels), channels)
    img = img.reshape(h, w, channels)
    if channels == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return img
