"""The port's file skyboxes (trident_tpu_torch/assets/skybox.py) against
the JAX package's, on the CPU.

  * face discovery by px/nx/py/ny/pz/nz tokens and the six faces, from PNG
    faces the port writes (io/image.py::save_png), equal to the JAX loads;
    EXR faces (an uncompressed OpenEXR file written here) go through
    imageio in both: the same faces where an imageio backend decodes EXR,
    else the same ValueError and the same fallback;
  * the solid-colour fallback on a missing source, with its warning;
  * KTX1 (tools_dev/scenes.py::write_ktx1_cubemap) and KTX2 cube maps with
    their mip chains through load_skybox_mips, equal to the JAX loads and
    to the levels written;
  * a 128² frame under a skybox loaded from files, through each package's
    Renderer (set_skybox(levels[0], mips=levels[1:])) on the reference
    raster, under the golden gate, and the chain level each Renderer picks
    for a large and a small viewport.
"""

import logging
import struct

import numpy as np
import pytest
import torch

from trident_tpu.assets import skybox as jsky
from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.render.renderer import Renderer as JRenderer
from trident_tpu_torch.assets import skybox
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.io.image import save_png
from trident_tpu_torch.render.renderer import Renderer
from trident_tpu_torch.tools_dev import scenes

from test_torch_frame import _assert_golden_gate

torch.set_num_threads(1)

TOKENS = ("px", "nx", "py", "ny", "pz", "nz")


def _same_levels(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert np.array_equal(x, y)


def test_discover_and_load_png_faces(tmp_path):
    faces = scenes.sky_levels_u8(16)[0]
    for face, token in zip(faces, TOKENS):
        save_png(str(tmp_path / f"sky_{token}.png"), face[..., :3])
    (tmp_path / "readme.txt").write_text("not a face")
    paths = skybox.discover_faces(str(tmp_path))
    assert paths == jsky.discover_faces(str(tmp_path))
    assert [p.rsplit("_", 1)[1][:2] for p in paths] == list(TOKENS)
    levels = skybox.load_skybox_mips(str(tmp_path))
    _same_levels(levels, jsky.load_skybox_mips(str(tmp_path)))
    _same_levels(levels, scenes.sky_arrays([faces]))
    # explicit paths, resampled to another edge
    assert np.array_equal(skybox.load_faces(paths, edge=8),
                          jsky.load_faces(paths, edge=8))


def write_exr(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) float image as an uncompressed scanline OpenEXR file
    (FLOAT B, G, R channels, one line a block)."""
    h, w, _ = rgb.shape

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<iBxxx", 20000630, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", b"\0")
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    lines = [struct.pack("<ii", y, 12 * w)
             + rgb[y, :, ::-1].T.astype("<f4").tobytes() for y in range(h)]
    offset = len(header) + 8 * h
    table = b""
    for line in lines:
        table += struct.pack("<Q", offset)
        offset += len(line)
    with open(path, "wb") as f:
        f.write(header + table + b"".join(lines))


def _load_or_error(load, *args):
    try:
        return load(*args)
    except ValueError as exc:
        return f"ValueError: {str(exc).split(':', 1)[0]}"


def test_exr_faces_through_imageio(tmp_path):
    """EXR faces go through imageio in both packages: the same faces where
    an imageio backend decodes EXR, else the same ValueError from the face
    loader and the same solid fallback from load_skybox_mips."""
    faces = scenes.gradient_faces(8)
    for face, token in zip(faces, TOKENS):
        write_exr(tmp_path / f"{token}.exr", face)
    one = str(tmp_path / "px.exr")
    got = _load_or_error(skybox._load_face, one, None)
    want = _load_or_error(jsky._load_face, one, None)
    if isinstance(want, str):
        assert got == want == "ValueError: EXR load failed for " + one
    else:
        assert np.array_equal(got, want)
        assert np.allclose(got, faces[0], atol=1e-6)
    _same_levels(skybox.load_skybox_mips(str(tmp_path)),
                 jsky.load_skybox_mips(str(tmp_path)))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_fallback_on_a_missing_source(tmp_path):
    records = _Records()
    log = logging.getLogger("trident.assets.skybox")
    for source in (tmp_path / "missing", tmp_path / "sky.hdr"):
        log.addHandler(records)
        try:
            levels = skybox.load_skybox_mips(str(source))
        finally:
            log.removeHandler(records)
        _same_levels(levels, jsky.load_skybox_mips(str(source)))
        assert len(levels) == 1
        assert np.array_equal(levels[0], skybox.solid_skybox())
    assert len(records.messages) == 2
    assert all("solid fallback" in m for m in records.messages)


@pytest.mark.parametrize("kind", ["ktx1", "ktx2"])
def test_cubemap_mip_chain(kind, tmp_path):
    levels_u8 = scenes.sky_levels_u8(32)
    if kind == "ktx1":
        path = scenes.write_ktx1_cubemap(tmp_path / "sky.ktx", levels_u8)
        assert np.array_equal(skybox.load_ktx1_cubemap(path),
                              scenes.sky_arrays(levels_u8)[0])
    else:
        path = scenes.write_sky_ktx2(tmp_path / "sky.ktx2", 32, scheme=3)
    levels = skybox.load_skybox_mips(path)
    _same_levels(levels, jsky.load_skybox_mips(path))
    _same_levels(levels, scenes.sky_arrays(levels_u8))
    assert [lv.shape[1] for lv in levels] == [32, 16, 8, 4, 2, 1]
    assert np.array_equal(skybox.load_skybox(path), levels[0])


def _sky_frames(levels, port: bool):
    """A 128² empty scene before the skybox `levels`, looking up and then
    toward −z, on the reference raster; and the face edges each Renderer
    picks for a 2048- and an 8-row viewport."""
    if port:
        r = Renderer(EngineConfig(render=RenderConfig(
            width=128, height=128, use_pallas=False)), device="cpu")
        r.set_active_registry(Registry())
    else:
        r = JRenderer(JEngineConfig(render=JRenderConfig(
            width=128, height=128, use_pallas=False)))
        r.set_active_registry(JRegistry())
    r.set_skybox(levels[0], mips=levels[1:])
    frames = []
    r.editor_camera.set_position([0, 0, 0])
    for rotation in ([60.0, 0, 0], [0.0, 30.0, 0]):
        r.editor_camera.set_rotation(rotation)
        frames.append(np.asarray(r.read_frame()))
    picks = [r._skybox_for(h, 60.0).faces.shape[1] for h in (2048, 8)]
    return frames, picks


def test_file_skybox_frame_matches_jax(tmp_path):
    path = scenes.write_sky_ktx2(tmp_path / "sky.ktx2", 64)
    levels = skybox.load_skybox_mips(path)
    port, port_picks = _sky_frames(levels, True)
    jax, jax_picks = _sky_frames(jsky.load_skybox_mips(path), False)
    assert port_picks == jax_picks and port_picks[0] == 64 > port_picks[1]
    for p, j in zip(port, jax):
        _assert_golden_gate(p, j)
        assert len(np.unique(p[..., :3].reshape(-1, 3), axis=0)) > 20
