"""The port's frames against the JAX package's PNG goldens
(tests/goldens/*.png) under the gate of test_golden_flavors.py: fewer than
0.2% of the RGBA8 values off by more than 3 LSB, mean absolute difference
below 0.35.

  * flavor_pallas_forward.png: the `_base` scene at 128² on the Pallas path
    with forward shading and a 128² hard shadow map; the JAX Renderer runs
    it with its zskip and zorder knobs, which skip and order work but
    change no pixel, and the port runs neither. The same scene's op-by-op
    JAX frame is committed as tests/goldens/torch_slice_pallas_forward.npy
    for chip_smoke.py.
  * scene_128.png and flavor_{shadows_pcf,ssaa,bloom,trilinear,skybox,
    sprite,f16_planes}.png: the scenes of tests/test_golden.py and
    test_golden_flavors.py built on the port from the same parameters
    (tools_dev/scenes.py::png_scene) on the plane-gather routes: the
    reference raster, and for f16_planes the binned raster with f16
    attribute planes.
  * flavor_skinned.png: the glTF rig of tests/test_assets.py::
    make_skinned_gltf (written by tools_dev/scenes.py::write_rig_gltf)
    imported into a Scene through import_model_entities, played, and
    posed by the Scene's AnimationSystem on the reference raster.

The PNGs are read with the JAX package's loader (PIL) and with the port's
own reader (io/image.py::read_png, the card's machine has no PIL), which
must agree byte for byte.
"""

import pathlib

import numpy as np
import pytest
import torch

from trident_tpu.io.image import load_rgba8

from trident_tpu_torch.io.image import read_png
from trident_tpu_torch.tools_dev.scenes import (
    PNG_GOLDENS,
    feature_scene,
    png_scene,
)

from test_torch_frame import _assert_golden_gate, check_feature_frame

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
GOLDEN = GOLDENS / "flavor_pallas_forward.png"


def png_path(name: str) -> pathlib.Path:
    """The PNG golden of PNG_GOLDENS entry `name`."""
    return GOLDENS / (f"{name}.png" if name == "scene_128"
                      else f"flavor_{name}.png")


def test_pallas_forward_frame_passes_the_png_golden():
    r = feature_scene("pallas_forward", "cpu")
    assert r.config.render.shadows and r.config.render.shadow_map_size == 128
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0] and out.shadow_aux.tolist() == [0, 0]
    golden = load_rgba8(str(GOLDEN))
    assert golden.shape == (128, 128, 4)
    _assert_golden_gate(r.read_frame(out), golden)
    # the frame is the scene: the cube and the ground cover it, and the
    # sun's shadow darkens some of the ground
    assert int((out.tri_id >= 0).sum()) > 5000


def test_pallas_forward_reference_is_the_jax_frame(tmp_path):
    """The committed torch_slice_pallas_forward.npy is the JAX package's
    op-by-op frame of the scene, and the port's frame is within the gate of
    it (equal triangle ids, aux [0, 0])."""
    _r, out, _jcolor = check_feature_frame("pallas_forward", tmp_path)
    assert out.shadow_aux.tolist() == [0, 0]


@pytest.mark.parametrize("name", PNG_GOLDENS)
def test_plane_route_frame_passes_the_png_golden(name):
    """The port's frame of each PNG golden's scene on its route: aux
    [0, 0] on the main pass (and the light pass), the scene covering the
    frame, and the gate against the PNG."""
    r = png_scene(name, "cpu")
    rc = r.config.render
    assert (rc.use_pallas is False) == (name != "f16_planes")
    assert rc.forward_shading == (name != "f16_planes")
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0]
    if rc.shadows:
        assert out.shadow_aux.tolist() == [0, 0]
    assert int((out.tri_id >= 0).sum()) > 1000
    _assert_golden_gate(r.read_frame(out), load_rgba8(str(png_path(name))))


def test_skinned_frame_is_posed_by_the_animation_system():
    """flavor_skinned's frame: the Scene's runtime registry holds the
    pose the AnimationSystem sampled at 0.5 s (half bent), within 3e-5 of
    the port's AnimationPlayer, and the frame passes the PNG golden."""
    from trident_tpu_torch.anim.player import AnimationPlayer
    from trident_tpu_torch.anim.service import AnimationAssetService
    from trident_tpu_torch.ecs.components import AnimationComponent

    from test_torch_anim import reset_animation_state

    reset_animation_state()
    try:
        r = png_scene("skinned", "cpu")
        (_e, (anim,)), = list(r.registry.view(AnimationComponent))
        assert anim.time == 0.5 and anim.bone_matrices.shape == (2, 4, 4)
        service = AnimationAssetService.get()
        player = AnimationPlayer(service.acquire_skeleton(anim.skeleton_asset))
        player.set_clip(service.acquire_animation_library(
            anim.animation_asset)[0])
        np.testing.assert_allclose(anim.bone_matrices,
                                   player.evaluate_at(0.5), atol=3e-5, rtol=0)
        out = r.render_viewport()
        assert out.aux.tolist() == [0, 0]
        _assert_golden_gate(r.read_frame(out),
                            load_rgba8(str(png_path("skinned"))))
    finally:
        reset_animation_state()


@pytest.mark.parametrize("path", sorted(p.name for p in GOLDENS.glob("*.png")))
def test_read_png_equals_the_jax_loader(path):
    img = read_png(GOLDENS / path)
    ref = load_rgba8(str(GOLDENS / path))
    assert img.dtype == ref.dtype == np.uint8 and img.shape == ref.shape
    assert img.tobytes() == ref.tobytes()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, img: np.ndarray) -> None:
    """An 8-bit PNG of img (H, W, 3 | 4) whose row y uses filter y % 5
    (None, Sub, Up, Average, Paeth), written with numpy and zlib."""
    import struct
    import zlib

    h, w, ch = img.shape
    rows, prior = [], np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        up_left = np.concatenate([np.zeros(ch, np.int32), prior[:-ch]])
        pred = [0, left, prior, (left + prior) >> 1,
                _paeth(left, prior, up_left)][y % 5]
        rows.append(bytes([y % 5]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    colour = {4: 6, 3: 2}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [4, 3], ids=["RGBA", "RGB"])
def test_read_png_every_filter(channels, tmp_path):
    """A seeded noisy image written with every one of PNG's five row
    filters (row y uses filter y % 5) reads back exactly, as PIL reads
    it; RGB gets alpha 255."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (23, 17, channels)).astype(np.uint8)
    path = tmp_path / "filters.png"
    _write_png(path, img)
    got = read_png(path)
    assert got.shape == (23, 17, 4)
    assert got[..., :channels].tobytes() == img.tobytes()
    assert got.tobytes() == load_rgba8(str(path)).tobytes()
    if channels == 3:
        assert (got[..., 3] == 255).all()
    with pytest.raises(ValueError):
        read_png(GOLDENS / "torch_slice_cube256.npy")
