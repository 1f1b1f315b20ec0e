"""Text overlay: queued strings → alpha-composited overlay (port of
trident_tpu/io/text_overlay.py).

Reference: Renderer/TextRenderer.{h,cpp} — stb_truetype atlas, per-viewport
queued text, dedicated alpha-blend pipeline after the scene pass. Text is
rasterized host-side into a per-viewport RGBA overlay that the renderer
alpha-composites onto the read-back frame — UI text is an overlay concern,
not 3D geometry.

The JAX module draws DejaVu Sans Mono through PIL. The port draws without
PIL, from a committed glyph atlas (assets/font_dejavu_sans_mono.npz,
written by tools_dev/make_font_atlas.py from PIL's own rendering of the
font): for each size 8–48 and each printable ASCII character, and the
missing-glyph box, the glyph's alpha mask, its offset from the pen, and
the advance PIL's `getlength` gives. Composition follows PIL's
ImageDraw.text: pens at multiples of the advance (in 1/64 px), each glyph
at its pen rounded half up, the glyphs of a line composited in order
into one mask (each glyph's alpha over the line's so far), lines `getbbox("A")[3] + 4` px apart, and the mask blended with the
colour into the overlay as Pillow's fill_mask_L blends an "L" mask into
RGBA. Every other character draws the box (PIL draws the font's glyph
where DejaVu has one), and a size outside 8–48 raises ValueError.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

ATLAS_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "font_dejavu_sans_mono.npz")
FIRST_CHAR, LAST_CHAR = 32, 126      # printable ASCII; the box follows
BOX = LAST_CHAR - FIRST_CHAR + 1     # the missing-glyph box's index
LINE_SPACING = 4                     # ImageDraw.text's `spacing`


@dataclass
class QueuedText:
    text: str
    x: int
    y: int
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    size: int = 16


class GlyphAtlas:
    """The atlas file's arrays: `sizes` (S,), `advance64` (S,) in 1/64 px,
    `line_bottom` (S,) (getbbox("A")[3]), `glyphs` (S, G, 5) rows of
    (pixel offset, h, w, x offset, y offset) into `pixels` (N,) uint8."""

    def __init__(self, path: str = ATLAS_PATH) -> None:
        with np.load(path) as z:
            self.sizes = z["sizes"].astype(np.int64)
            self.advance64 = z["advance64"].astype(np.int64)
            self.line_bottom = z["line_bottom"].astype(np.int64)
            self.glyphs = z["glyphs"].astype(np.int64)
            self.pixels = z["pixels"]
        self._row = {int(s): i for i, s in enumerate(self.sizes)}

    def size_row(self, size: int) -> int:
        row = self._row.get(int(size))
        if row is None:
            raise ValueError(
                f"text size {size} is outside the glyph atlas's "
                f"{int(self.sizes.min())}-{int(self.sizes.max())}")
        return row

    def glyph(self, row: int, ch: str):
        """(mask (h, w) uint8, x offset, y offset) of `ch` at size row."""
        code = ord(ch)
        g = (code - FIRST_CHAR if FIRST_CHAR <= code <= LAST_CHAR else BOX)
        off, h, w, ox, oy = (int(v) for v in self.glyphs[row, g])
        return self.pixels[off:off + h * w].reshape(h, w), ox, oy

    def line_mask(self, line: str, size: int):
        """One line's mask as PIL's getmask2 builds it, each glyph's
        alpha over the mask so far (src + dst·(255 − src) / 255, Pillow's
        rounding): (mask, x0, y0) with the mask's top-left at (x0, y0) from
        the line's origin, or None when the line draws nothing."""
        row = self.size_row(size)
        adv = int(self.advance64[row])
        placed = []
        for i, ch in enumerate(line):
            mask, ox, oy = self.glyph(row, ch)
            if mask.size:
                placed.append((mask, ((i * adv + 32) >> 6) + ox, oy))
        if not placed:
            return None
        x0 = min(p[1] for p in placed)
        y0 = min(p[2] for p in placed)
        x1 = max(p[1] + p[0].shape[1] for p in placed)
        y1 = max(p[2] + p[0].shape[0] for p in placed)
        out = np.zeros((y1 - y0, x1 - x0), np.int32)
        for mask, gx, gy in placed:
            win = out[gy - y0:gy - y0 + mask.shape[0],
                      gx - x0:gx - x0 + mask.shape[1]]
            src = mask.astype(np.int32)
            v = win * (255 - src) + 128
            win[...] = src + (((v >> 8) + v) >> 8)
        return out.astype(np.uint8), x0, y0

    def lines(self, text: str, size: int):
        """(line, y offset) pairs of ImageDraw.text's multiline split:
        lines `getbbox("A")[3] + 4` px apart, left aligned."""
        step = int(self.line_bottom[self.size_row(size)]) + LINE_SPACING
        return [(line, k * step) for k, line in enumerate(text.split("\n"))]


def fill_mask(image: np.ndarray, mask: np.ndarray, x: int, y: int,
              ink) -> None:
    """Blend an "L" mask with the colour `ink` (4 ints) into an (H, W, 4)
    uint8 RGBA image at (x, y), clipped to the image, as Pillow's
    fill_mask_L does: each channel out·(255 − m) + ink·m over 255 with
    its rounding, where m is the mask, except that a colour channel takes
    m = 255 where the pixel's alpha was 0 and the mask is not."""
    h, w = image.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + mask.shape[1], w), min(y + mask.shape[0], h)
    if x0 >= x1 or y0 >= y1:
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)[..., None]
    win = image[y0:y1, x0:x1]
    out = win.astype(np.int32)
    cm = np.where((out[..., 3:4] == 0) & (m != 0), 255, m)
    cm = np.concatenate([np.broadcast_to(cm, out[..., :3].shape), m], -1)
    v = out * (255 - cm) + np.asarray(ink, np.int32) * cm + 128
    win[...] = ((v >> 8) + v) >> 8


class TextOverlay:
    """Per-viewport text queues → (H,W,4) uint8 overlay images. `font_path`
    names another atlas file of make_font_atlas.py's layout (the JAX
    overlay takes a TrueType file there)."""

    def __init__(self, font_path: Optional[str] = None) -> None:
        self._queues: Dict[int, List[QueuedText]] = {}
        self._font_path = font_path
        self._atlas: Optional[GlyphAtlas] = None

    @property
    def atlas(self) -> GlyphAtlas:
        if self._atlas is None:
            self._atlas = GlyphAtlas(self._font_path or ATLAS_PATH)
        return self._atlas

    def queue_text(self, viewport_id: int, text: str, x: int, y: int,
                   color=(1.0, 1.0, 1.0, 1.0), size: int = 16) -> None:
        """Queue a string; a size outside the atlas's 8–48 raises
        ValueError here."""
        self.atlas.size_row(int(size))
        self._queues.setdefault(viewport_id, []).append(
            QueuedText(text, int(x), int(y), tuple(color), int(size)))

    def begin_frame(self) -> None:
        self._queues.clear()

    def clear_viewport(self, viewport_id: int) -> None:
        self._queues.pop(viewport_id, None)

    def has_text(self, viewport_id: int) -> bool:
        return bool(self._queues.get(viewport_id))

    def render_overlay(self, viewport_id: int, width: int, height: int) -> Optional[np.ndarray]:
        """Rasterize this viewport's queue → (H,W,4) uint8 (None if empty)."""
        queue = self._queues.get(viewport_id)
        if not queue:
            return None
        img = np.zeros((height, width, 4), np.uint8)
        for item in queue:
            rgba = tuple(int(np.clip(c, 0, 1) * 255) for c in item.color)
            for line, dy in self.atlas.lines(item.text, item.size):
                placed = self.atlas.line_mask(line, item.size)
                if placed is not None:
                    mask, mx, my = placed
                    fill_mask(img, mask, item.x + mx, item.y + dy + my, rgba)
        return img


def composite_overlay(frame: np.ndarray, overlay: np.ndarray) -> np.ndarray:
    """Host-side alpha-over compositing (uint8)."""
    a = overlay[..., 3:4].astype(np.float32) / 255.0
    rgb = (overlay[..., :3].astype(np.float32) * a
           + frame[..., :3].astype(np.float32) * (1.0 - a))
    out = frame.copy()
    out[..., :3] = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    return out
