"""Write the text overlay's glyph atlas (assets/font_dejavu_sans_mono.npz).

    python3 -m trident_tpu_torch.tools_dev.make_font_atlas [--font TTF]
        [--out NPZ] [--license COPYRIGHT]

Renders DejaVu Sans Mono through PIL, as the JAX package's
io/text_overlay.py draws it (ImageDraw.text on an "L" canvas), at sizes
8–48: each printable ASCII character and the missing-glyph box, each
glyph's mask cropped to its ink with its offset from the pen, the advance
`getlength` gives in 1/64 px, and `getbbox("A")[3]` for the line spacing.
Then it checks the atlas against PIL: at every size, lines holding every
character (and every character after every other), a three-line string,
and overlapping strings in RGBA, composed by io/text_overlay.py, must
equal ImageDraw.text pixel for pixel; any difference raises. The .npz is
written with fixed zip timestamps, so a rerun gives the same bytes, and
the font's copyright file is copied beside it.

It needs PIL and the font file, and runs on a machine that has both; the
port itself never imports PIL.
"""

from __future__ import annotations

import argparse
import io
import os
import shutil
import zipfile

import numpy as np

from trident_tpu_torch.io import text_overlay as to

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"
COPYRIGHT = "/usr/share/doc/fonts-dejavu-core/copyright"
SIZES = range(8, 49)
MISSING = "\ue000"   # a code point DejaVu Sans Mono lacks: the box
PRINTABLE = "".join(chr(c) for c in range(to.FIRST_CHAR, to.LAST_CHAR + 1))


def glyph_chars() -> list:
    return list(PRINTABLE) + [MISSING]


def render_glyph(font, ch: str, size: int):
    """(mask (h, w) uint8 cropped to its ink, x offset, y offset) of one
    character drawn by ImageDraw.text at an integer origin."""
    from PIL import Image, ImageDraw

    pad = 2 * size
    img = Image.new("L", (5 * size, 5 * size), 0)
    ImageDraw.Draw(img).text((pad, pad), ch, fill=255, font=font)
    a = np.asarray(img)
    ys, xs = np.nonzero(a)
    if ys.size == 0:
        return np.zeros((0, 0), np.uint8), 0, 0
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    if y0 == 0 or x0 == 0 or y1 == a.shape[0] or x1 == a.shape[1]:
        raise AssertionError(f"size {size} {ch!r}: the glyph touches the "
                             "canvas edge")
    return np.ascontiguousarray(a[y0:y1, x0:x1]), int(x0 - pad), int(y0 - pad)


def build(font_path: str = FONT) -> dict:
    """The atlas's arrays (GlyphAtlas's layout)."""
    from PIL import ImageFont

    chars = glyph_chars()
    advance64, line_bottom, pixels = [], [], []
    glyphs = np.zeros((len(SIZES), len(chars), 5), np.int32)
    n = 0
    for row, size in enumerate(SIZES):
        font = ImageFont.truetype(font_path, size)
        adv = font.getlength("a")
        advance64.append(int(round(adv * 64)))
        if advance64[-1] != adv * 64:
            raise AssertionError(f"size {size}: advance {adv} is not in "
                                 "1/64 px")
        for ch in chars:
            if font.getlength(ch) != adv:
                raise AssertionError(f"size {size} {ch!r}: advance "
                                     f"{font.getlength(ch)} != {adv}")
        line_bottom.append(int(font.getbbox("A")[3]))
        for g, ch in enumerate(chars):
            mask, ox, oy = render_glyph(font, ch, size)
            glyphs[row, g] = (n, mask.shape[0], mask.shape[1], ox, oy)
            pixels.append(mask.reshape(-1))
            n += mask.size
    return {"sizes": np.asarray(list(SIZES), np.int32),
            "advance64": np.asarray(advance64, np.int32),
            "line_bottom": np.asarray(line_bottom, np.int32),
            "glyphs": glyphs, "pixels": np.concatenate(pixels)}


def write_npz(path: str, arrays: dict) -> None:
    """np.savez_compressed's layout with fixed entry timestamps."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arrays[name]),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue(), compresslevel=9)


def check_strings() -> list:
    """Lines that hold every character, and every character after every
    other (kerning, overlaps), plus a multiline string."""
    pairs = "".join(a + b for a in PRINTABLE for b in PRINTABLE[::7])
    return [PRINTABLE, PRINTABLE[::-1], pairs[:400], pairs[400:800],
            "mw_|W@#\n  ok {}[]\nfps 59.94 ~`'\"", MISSING + "a\tb"]


def pil_overlay(items, width: int, height: int, font_path: str = FONT):
    """The JAX overlay's drawing: ImageDraw.text of each (text, x, y,
    rgba, size) onto one transparent RGBA image."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("RGBA", (width, height), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    for text, x, y, rgba, size in items:
        draw.text((x, y), text, fill=rgba,
                  font=ImageFont.truetype(font_path, size))
    return np.asarray(img, dtype=np.uint8)


def port_overlay(atlas_path: str, items, width: int, height: int):
    ov = to.TextOverlay(atlas_path)
    for text, x, y, rgba, size in items:
        ov.queue_text(0, text, x, y, tuple(c / 255.0 for c in rgba), size)
    return ov.render_overlay(0, width, height)


def check(atlas_path: str, font_path: str = FONT) -> None:
    """Every size: each check string in white on its own image, and two
    overlapping strings in translucent colours (the RGBA blend), equal
    to ImageDraw.text; raises AssertionError on the first difference."""
    for size in SIZES:
        for text in check_strings():
            lines = text.split("\n")
            w = int(max(len(ln) for ln in lines) * size * 0.62) + 3 * size
            h = len(lines) * (size + 8) + 2 * size
            items = [(text, size // 3, 2, (255, 255, 255, 255), size)]
            want = pil_overlay(items, w, h, font_path)
            got = port_overlay(atlas_path, items, w, h)
            if not (got == want).all():
                raise AssertionError(
                    f"size {size} {text[:20]!r}: "
                    f"{int((got != want).any(-1).sum())} pixels differ")
        items = [("Overlap 123", 1, 1, (255, 0, 0, 255), size),
                 ("overlap 456", size // 2 - 3, size // 3 - 2,
                  (0, 128, 255, 160), size),
                 ("edge", -size // 2, -size // 4, (10, 250, 20, 200), size)]
        w, h = 8 * size, 3 * size
        want = pil_overlay(items, w, h, font_path)
        got = port_overlay(atlas_path, items, w, h)
        if not (got == want).all():
            raise AssertionError(f"size {size}, overlapping strings: "
                                 f"{int((got != want).any(-1).sum())} "
                                 "pixels differ")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--font", default=FONT)
    parser.add_argument("--out", default=to.ATLAS_PATH)
    parser.add_argument("--license", default=COPYRIGHT)
    args = parser.parse_args(argv)
    write_npz(args.out, build(args.font))
    check(args.out, args.font)
    lic = os.path.join(os.path.dirname(args.out),
                       "font_dejavu_sans_mono.copyright")
    shutil.copyfile(args.license, lic)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) and {lic}; "
          f"sizes {SIZES.start}-{SIZES.stop - 1} equal to ImageDraw.text")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
