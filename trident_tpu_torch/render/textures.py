"""Texture slot cache (port of trident_tpu/render/textures.py).

Slots live in ONE flat table of per-slot mip pyramids of 2×2 texel quads,
built on the host in numpy exactly as the JAX package builds it and placed
on the device on change (cached by version and device). Slot 0 is the 1×1
white fallback. Non-square / non-pow2 images sit in the top-left of their
pow2 tile; the sampler wraps by the ACTUAL size so REPEAT stays correct.
A slot may carry a file mip chain (`acquire(key, rgba, mips=)`): its
levels replace the box downsample wherever their size matches the
pyramid's (trident_tpu/render/textures.py:84-180).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.render.types import TextureArrays


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """2× box filter; odd dims are truncated (sizes are pow2-padded)."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    img = img[: h2 * 2, : w2 * 2].astype(np.float32)
    if h >= 2 and w >= 2:
        out = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
               + img[1::2, 1::2]) * 0.25
    elif h >= 2:
        out = (img[0::2] + img[1::2]) * 0.5
    elif w >= 2:
        out = (img[:, 0::2] + img[:, 1::2]) * 0.5
    else:
        out = img
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _sanitize(rgba: np.ndarray) -> np.ndarray:
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        rgba = np.clip(np.round(np.asarray(rgba, np.float32) * 255.0),
                       0, 255).astype(np.uint8)
    if rgba.ndim == 2:
        rgba = rgba[..., None]
    if rgba.shape[-1] == 3:
        rgba = np.concatenate(
            [rgba, np.full((*rgba.shape[:2], 1), 255, np.uint8)], axis=-1)
    elif rgba.shape[-1] == 1:
        rgba = np.concatenate(
            [np.repeat(rgba, 3, axis=-1),
             np.full((*rgba.shape[:2], 1), 255, np.uint8)], axis=-1)
    return rgba


def pack_quads(images: List[np.ndarray], sizes_wh: List[Tuple[int, int]],
               n_slots: int, edge_cap: int,
               mips: Optional[List[Optional[List[np.ndarray]]]] = None
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(quads (N,4) u32, sizes (S,4) i32, max level) for the slot images.
    Texel (s,l,y,x) sits at entry (sizes[s,2]<<8) + level_base(E_s,l)
    + y·((E_s>>l)+1) + x, and quads[entry] = [(x,y),(x+1,y),(x,y+1),
    (x+1,y+1)]; each level carries wrap-gutter column lw := col 0 and row
    lh := row 0; slot bases align to 256 entries. `mips[s]` is slot s's
    file mip chain (or None): a level of the size the pyramid wants next
    (half the previous, at least 1) takes the first file level of that
    size, any other is box-downsampled from the previous one."""
    n = len(images)
    sizes = np.ones((n_slots, 4), np.int32)
    chunks: List[np.ndarray] = []
    cursor = 0
    max_edge = 1
    for i in range(n_slots):
        img = images[i] if i < n else np.full((1, 1, 4), 255, np.uint8)
        w0, h0 = sizes_wh[i] if i < n else (1, 1)
        e0 = 1 << int(max(w0, h0, 1) - 1).bit_length()       # pow2 ceil
        e0 = min(max(e0, 1), edge_cap)
        max_edge = max(max_edge, e0)
        n_levels = e0.bit_length()                           # log2(e0)+1
        sizes[i] = (w0, h0, cursor >> 8, e0)
        file_mips = (mips[i] if mips is not None and i < n else None) or []
        chain = [img]
        while len(chain) < n_levels:
            prev = chain[-1]
            want = (max(prev.shape[0] // 2, 1), max(prev.shape[1] // 2, 1))
            m = next((fm for fm in file_mips if fm.shape[:2] == want), None)
            chain.append(m if m is not None else _box_downsample(prev))
        total = 0
        parts = []
        for lvl in range(n_levels):
            cur = chain[lvl]
            e = max(e0 >> lvl, 1)
            tile = np.zeros((e + 1, e + 1, 4), np.uint8)
            ch, cw = min(cur.shape[0], e), min(cur.shape[1], e)
            tile[:ch, :cw] = cur[:ch, :cw]
            lw = min(max(int(w0) >> lvl, 1), e)
            lh = min(max(int(h0) >> lvl, 1), e)
            tile[:, lw] = tile[:, 0]           # REPEAT gutter at actual w
            tile[lh, :] = tile[0, :]           # REPEAT gutter at actual h
            flat = tile.reshape(-1, 4).astype(np.uint32)
            packed = (flat[:, 0] | (flat[:, 1] << 8)
                      | (flat[:, 2] << 16) | (flat[:, 3] << 24))
            stride = e + 1
            grid = packed.reshape(stride, stride)
            q = np.zeros((stride, stride, 4), np.uint32)
            q[..., 0] = grid
            q[:, :-1, 1] = grid[:, 1:]
            q[:-1, :, 2] = grid[1:, :]
            q[:-1, :-1, 3] = grid[1:, 1:]
            parts.append(q.reshape(-1, 4))
            total += stride * stride
        pad = (-(cursor + total)) % 256
        if pad:
            parts.append(np.zeros((pad, 4), np.uint32))
        chunk = np.concatenate(parts, axis=0)
        chunks.append(chunk)
        cursor += chunk.shape[0]
    return np.concatenate(chunks, axis=0), sizes, max_edge.bit_length() - 1


class TextureSlots:
    """Host-side slot registry + the packed device table."""

    def __init__(self, max_slots: int = 256, edge: int = 256):
        self.max_slots = max_slots
        self.edge = edge
        self._images: List[np.ndarray] = []
        self._mips: List[Optional[List[np.ndarray]]] = []   # file chains
        self._sizes: List[Tuple[int, int]] = []
        self._by_path: Dict[str, int] = {}
        self.version = 0
        self._device: Optional[TextureArrays] = None
        self._device_key = None
        self._push(np.full((1, 1, 4), 255, np.uint8), "__white__")

    def _push(self, rgba: np.ndarray, key: str,
              mips: Optional[List[np.ndarray]] = None) -> int:
        slot = len(self._images)
        if slot >= self.max_slots:
            return 0  # out of slots → white fallback, like the reference
        self._images.append(rgba)
        self._mips.append(mips)
        self._sizes.append((rgba.shape[1], rgba.shape[0]))
        self._by_path[key] = slot
        self.version += 1
        return slot

    def _fit(self, rgba: np.ndarray) -> np.ndarray:
        rgba = _sanitize(rgba)
        while rgba.shape[0] > self.edge or rgba.shape[1] > self.edge:
            rgba = _box_downsample(rgba)
        return rgba

    def acquire(self, key: str, rgba: Optional[np.ndarray] = None,
                mips: Optional[List[np.ndarray]] = None) -> int:
        """Get-or-create a slot; with `rgba` None the key must exist (else
        the white slot 0). `mips` is an optional file mip chain (levels
        below mip 0, any suffix), used wherever a level's size matches the
        pyramid's."""
        if key in self._by_path:
            return self._by_path[key]
        if rgba is None:
            return 0
        return self._push(self._fit(rgba), key,
                          [_sanitize(m) for m in mips] if mips else None)

    def replace(self, key: str, rgba: np.ndarray,
                mips: Optional[List[np.ndarray]] = None) -> int:
        """Hot reload: new pixels (and mip chain) for an existing slot, or
        a new slot for a new key; the next device_arrays repacks."""
        if key not in self._by_path:
            return self.acquire(key, rgba, mips)
        rgba = self._fit(rgba)
        slot = self._by_path[key]
        self._images[slot] = rgba
        self._mips[slot] = [_sanitize(m) for m in mips] if mips else None
        self._sizes[slot] = (rgba.shape[1], rgba.shape[0])
        self.version += 1
        return slot

    def lookup(self, key: str) -> int:
        """The slot of `key`, or the white slot 0."""
        return self._by_path.get(key, 0)

    def device_arrays(self, device=None) -> TextureArrays:
        """The packed table on `device` (cached by version and device).
        Slot count is bucketed to multiples of 8, as in the reference."""
        dev = resolve_device(device)
        key = (self.version, str(dev))
        if self._device is not None and self._device_key == key:
            return self._device
        n = len(self._images)
        bucket = max(8, 1 << (n - 1).bit_length()) if n > 8 else 8
        s = max(min(((n + bucket - 1) // bucket) * bucket, self.max_slots), n)
        quads, sizes, max_level = pack_quads(self._images, self._sizes, s,
                                             self.edge, self._mips)
        self._device = TextureArrays(
            quads=torch.from_numpy(quads.view(np.int32)).to(dev),
            sizes=torch.from_numpy(sizes).to(dev),
            max_level=torch.tensor(max_level, dtype=torch.int32, device=dev),
        )
        self._device_key = key
        return self._device
