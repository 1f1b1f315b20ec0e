"""The port's KTX2 container (trident_tpu_torch/assets/ktx2.py), SVG
rasterizer (io/svg.py) and image dispatch (io/image.py) against the JAX
package's, on the CPU.

  * KTX2: round trips under supercompression schemes 0 (none), 3 (zlib)
    and, where `zstandard` imports, 2 (zstd), each file written by one
    package and read by both; without `zstandard` a zstd file raises
    ImportError in both. RGB gains opaque alpha; cube maps (also through
    load_skybox); BasisLZ rejected; file mip chains whole and partial,
    through each package's TextureSlots to the same packed table; array
    stacks. The cases of tests/test_image_formats.py.
  * load_rgba8 / load_rgba8_mips dispatch .ktx2 and .svg as the JAX
    functions do, PNG still decodes, and PIL-only formats still raise.
  * SVG: the documents of tests/test_image_formats.py rasterized by both
    packages, bit-equal, and at a second output size.
"""

import struct
import sys

import numpy as np
import pytest
import torch

from trident_tpu.assets import ktx2 as jktx2
from trident_tpu.io import image as jimage
from trident_tpu.io.svg import rasterize_svg as j_rasterize
from trident_tpu.render.textures import TextureSlots as JSlots
from trident_tpu_torch.assets import ktx2
from trident_tpu_torch.assets.skybox import load_skybox
from trident_tpu_torch.io import image
from trident_tpu_torch.io.svg import rasterize_svg, rasterize_svg_file
from trident_tpu_torch.render.textures import TextureSlots

torch.set_num_threads(1)

try:
    import zstandard  # noqa: F401
    SCHEMES = (0, 2, 3)
except ImportError:
    SCHEMES = (0, 3)

WRITERS = {"port": ktx2.write_ktx2, "jax": jktx2.write_ktx2}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_ktx2_roundtrip(scheme, writer, tmp_path):
    tex = np.random.default_rng(0).integers(0, 255, (32, 48, 4), np.uint8)
    p = str(tmp_path / f"t{scheme}.ktx2")
    WRITERS[writer](p, tex, scheme=scheme)
    assert np.array_equal(ktx2.load_ktx2_rgba8(p), tex)
    assert np.array_equal(jktx2.load_ktx2_rgba8(p), tex)
    with open(p, "rb") as f:
        data = f.read()
    q = str(tmp_path / "other.ktx2")
    {"port": jktx2, "jax": ktx2}[writer].write_ktx2(q, tex, scheme=scheme)
    with open(q, "rb") as f:
        assert f.read() == data                 # the same bytes


def test_ktx2_zstd_needs_zstandard(tmp_path, monkeypatch):
    """Without the zstandard package a zstd payload raises ImportError in
    both packages, and the other schemes still load."""
    tex = np.full((4, 4, 4), 9, np.uint8)
    z = str(tmp_path / "z.ktx2")
    header = (jktx2._KTX2_MAGIC
              + struct.pack("<9I", 37, 1, 4, 4, 0, 0, 1, 1, 2)
              + struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0))
    entry = struct.pack("<3Q", len(header) + 24, 8, tex.nbytes)
    with open(z, "wb") as f:
        f.write(header + entry + b"\0" * 8)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for mod in (ktx2, jktx2):
        with pytest.raises(ImportError):
            mod.load_ktx2_rgba8(z)
    p = str(tmp_path / "zlib.ktx2")
    ktx2.write_ktx2(p, tex, scheme=3)
    assert np.array_equal(jktx2.load_ktx2_rgba8(p), tex)


def test_ktx2_rgb_gets_opaque_alpha(tmp_path):
    p = str(tmp_path / "rgb.ktx2")
    ktx2.write_ktx2(p, np.full((8, 8, 3), 7, np.uint8))
    out = ktx2.load_ktx2_rgba8(p)
    assert np.array_equal(out, jktx2.load_ktx2_rgba8(p))
    assert out.shape == (8, 8, 4)
    assert (out[..., 3] == 255).all() and (out[..., :3] == 7).all()


def test_ktx2_cubemap_and_skybox_path(tmp_path):
    faces = np.random.default_rng(1).integers(0, 255, (6, 16, 16, 4),
                                              np.uint8)
    p = str(tmp_path / "cube.ktx2")
    ktx2.write_ktx2(p, faces, cubemap=True, scheme=SCHEMES[-1])
    cube = ktx2.load_ktx2_cubemap(p)
    assert cube.shape == (6, 16, 16, 3) and cube.dtype == np.float32
    assert np.array_equal(cube, jktx2.load_ktx2_cubemap(p))
    assert np.array_equal(cube, faces[..., :3].astype(np.float32) / 255.0)
    assert np.array_equal(load_skybox(p), cube)


def test_ktx2_basis_rejected(tmp_path):
    p = str(tmp_path / "basis.ktx2")
    with open(p, "wb") as f:  # vkFormat 0 (UNDEFINED) + BasisLZ scheme
        f.write(ktx2._KTX2_MAGIC + struct.pack("<9I", 0, 1, 4, 4, 0, 0, 1, 1,
                                               1) + b"\0" * 80)
    for mod in (ktx2, jktx2):
        with pytest.raises(ValueError, match="transcoding"):
            mod.Ktx2File(p)


def _chain():
    red = np.zeros((4, 4, 4), np.uint8)
    red[..., 0], red[..., 3] = 255, 255
    green = np.zeros((2, 2, 4), np.uint8)
    green[..., 1], green[..., 3] = 200, 255
    blue = np.zeros((1, 1, 4), np.uint8)
    blue[..., 2], blue[..., 3] = 150, 255
    return red, green, blue


@pytest.mark.parametrize("levels", ["whole", "partial"])
def test_ktx2_file_mip_chain(levels, tmp_path):
    """A KTX2's own mip chain (whole, or its level 1 alone) read by both
    packages and packed by each TextureSlots: the same levels and the same
    packed table, whose levels are the file's where it has them and the
    box-filtered level above where it does not."""
    red, green, blue = _chain()
    mips = [green, blue] if levels == "whole" else [green]
    p = str(tmp_path / "chain.ktx2")
    ktx2.write_ktx2(p, red, scheme=SCHEMES[-1], mips=mips)
    img0, got = image.load_rgba8_mips(p)
    jimg0, jgot = jimage.load_rgba8_mips(p)
    assert np.array_equal(img0, red) and np.array_equal(jimg0, red)
    assert len(got) == len(jgot) == len(mips)
    for a, b, m in zip(got, jgot, mips):
        assert np.array_equal(a, m) and np.array_equal(b, m)
    slots, jslots = TextureSlots(edge=8), JSlots(edge=8)
    slot = slots.acquire("chain", img0, mips=got)
    assert jslots.acquire("chain", jimg0, mips=jgot) == slot
    arr, jarr = slots.device_arrays("cpu"), jslots.device_arrays()
    quads = arr.quads.numpy().view(np.uint32)
    assert np.array_equal(quads, np.asarray(jarr.quads).view(np.uint32))
    base = int(arr.sizes[slot, 2]) << 8
    l2 = int(quads[base + 5 * 5 + 3 * 3, 0])
    # level 2: the file's blue, or box(green) = green without it
    assert ((l2 >> 16) & 255, (l2 >> 8) & 255) == (
        (150, 0) if levels == "whole" else (0, 200))


def test_ktx2_array_stack_roundtrip(tmp_path):
    stack = np.random.default_rng(3).integers(0, 256, (4, 8, 8, 4),
                                              dtype=np.uint8)
    p = str(tmp_path / "arr.ktx2")
    ktx2.write_ktx2(p, stack)
    out = ktx2.Ktx2File(p).level_images(0)
    assert np.array_equal(out, stack)
    assert np.array_equal(out, jktx2.Ktx2File(p).level_images(0))


def test_load_rgba8_dispatches_ktx2_and_svg(tmp_path):
    tex = np.arange(8 * 8 * 4, dtype=np.uint8).reshape(8, 8, 4)
    p = str(tmp_path / "x.ktx2")
    ktx2.write_ktx2(p, tex)
    assert np.array_equal(image.load_rgba8(p), tex)
    assert image.load_rgba8_mips(p)[1] is None
    svg_p = str(tmp_path / "x.svg")
    with open(svg_p, "w") as f:
        f.write('<svg xmlns="http://www.w3.org/2000/svg" width="16" '
                'height="16"><rect width="16" height="16" fill="red"/></svg>')
    img = image.load_rgba8(svg_p)
    assert img.shape == (16, 16, 4) and tuple(img[8, 8, :2]) == (255, 0)
    for path in (p, svg_p):
        assert np.array_equal(image.load_rgba8(path), jimage.load_rgba8(path))
        rgba, mips = image.load_rgba8_mips(path)
        assert np.array_equal(rgba, jimage.load_rgba8(path)) and mips is None
    png = str(tmp_path / "x.png")
    image.save_png(png, tex)
    assert np.array_equal(image.load_rgba8(png), jimage.load_rgba8(png))
    jimage.save_png(str(tmp_path / "y.png"), tex[..., :3])
    assert np.array_equal(image.load_rgba8(str(tmp_path / "y.png")),
                          jimage.load_rgba8(str(tmp_path / "y.png")))
    with open(str(tmp_path / "x.bmp"), "wb") as f:
        f.write(b"BM" + b"\0" * 60)
    with pytest.raises(ValueError, match=r"\.bmp"):
        image.load_rgba8(str(tmp_path / "x.bmp"))


SVG_NS = '<svg xmlns="http://www.w3.org/2000/svg" '
# the documents of tests/test_image_formats.py's SVG cases
SVG_CASES = {
    "shapes_and_colors": SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <rect x="0" y="0" width="16" height="16" fill="#ff0000"/>
      <circle cx="24" cy="8" r="6" fill="rgb(0,255,0)"/>
      <ellipse cx="8" cy="24" rx="6" ry="4" fill="blue"/>
      <polygon points="18,18 30,18 24,30" fill="#0ff"/>
    </svg>''',
    "viewbox_and_transform": SVG_NS + '''width="40" height="40" viewBox="0 0 10 10">
      <path d="M0 0 H10 V5 H0 Z" fill="black"/>
      <g transform="translate(5,7.5) scale(2)">
        <rect x="-1" y="-1" width="2" height="2" fill="red"/>
      </g>
    </svg>''',
    "evenodd_hole": SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <path fill-rule="evenodd" fill="black"
            d="M2 2 H30 V30 H2 Z M10 10 H22 V22 H10 Z"/>
    </svg>''',
    "nonzero_no_hole": SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <path fill="black" d="M2 2 H30 V30 H2 Z M10 10 H22 V22 H10 Z"/>
    </svg>''',
    "stroke": SVG_NS + '''width="32" height="32" viewBox="0 0 32 32">
      <line x1="4" y1="16" x2="28" y2="16" stroke="white" stroke-width="4"/>
    </svg>''',
    "opacity": SVG_NS + '''width="8" height="8" viewBox="0 0 8 8">
      <rect width="8" height="8" fill="black"/>
      <rect width="8" height="8" fill="white" fill-opacity="0.5"/>
    </svg>''',
    "bezier_and_arc": SVG_NS + '''width="64" height="64" viewBox="0 0 64 64">
      <path d="M8 56 C 8 8, 56 8, 56 56 Z" fill="gray"/>
      <path d="M8 60 A 4 4 0 1 1 16 60 Z" fill="red"/>
    </svg>''',
    "malformed_path": SVG_NS + 'width="8" height="8">'
    '<path d="M 0 0 L 8 0 L 8 8 L 0 8 Z 5 5" fill="red"/></svg>',
    "short_path": SVG_NS + 'width="8" height="8"><path d="M 5"/></svg>',
    "style_beats_attr": SVG_NS + 'width="4" height="4">'
    '<rect width="4" height="4" fill="red" style="fill:blue"/></svg>',
    "group_opacity": SVG_NS + 'width="4" height="4"><g opacity="0.5">'
    '<rect width="4" height="4" fill="black" opacity="0.8"/></g></svg>',
    "polyline_closed": SVG_NS + 'width="4" height="4">'
    '<polyline points="0,0 4,0 4,4 0,4"/></svg>',
    "edge_antialias": SVG_NS + 'width="4" height="4">'
    '<rect width="3.5" height="4" fill="red"/></svg>',
}


@pytest.mark.parametrize("name", sorted(SVG_CASES))
def test_svg_matches_jax(name, tmp_path):
    doc = SVG_CASES[name]
    img = rasterize_svg(doc)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 4
    assert np.array_equal(img, j_rasterize(doc))
    assert np.array_equal(rasterize_svg(doc, width=24, height=20),
                          j_rasterize(doc, width=24, height=20))
    p = tmp_path / f"{name}.svg"
    p.write_text(doc)
    assert np.array_equal(rasterize_svg_file(str(p)), img)
