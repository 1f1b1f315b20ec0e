"""The banded multi-device frame (parallel/framebuffer.py) on the CPU:
render_frame_banded over [cpu] * n bands against the port's one-device
render_frame on the same inputs, and the Renderer's banded path
(RenderConfig.bands) with its fallbacks, mirroring tests/test_parallel.py.

Each band rasterizes and shades its rows at their global pixel centres
with the full frame's camera, so the banded frame must equal the
one-device frame bit for bit — colour, depth and ids — with every band's
aux [0, 0]; every flavor at n = 2 and 4, the forward one also at n = 3,
whose padded triangle slices end in invalid pad triangles. One forward
flavor is held against the JAX package's single-chip frame (its golden,
tests/goldens/torch_slice_shadows_hard.npy) under the golden gate of
tests/test_torch_frame.py. The banded :ai frame upscales through the V1
path (apply_upscaler), as the JAX banded frame does: against the
Renderer's one-device V2 frame it may differ by 1 LSB on < 0.5% of
values (test_parallel.py's gate), and it is bit-equal to the one-device
half-size frame put through apply_upscaler with the same temporal input.
"""

import logging
import pathlib

import numpy as np
import pytest
import torch

from trident_tpu_torch.parallel.framebuffer import render_frame_banded
from trident_tpu_torch.render.frame import geometry_to_device
from trident_tpu_torch.render.renderer import render_frame
from trident_tpu_torch.tools_dev.banded import (
    banded_kwargs,
    frame_diffs,
    one_device_v1,
)
from trident_tpu_torch.tools_dev.scenes import (
    feature_scene,
    golden_base_scene,
    skinned_png_scene,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
CKERN = {"ckern": True, "dynhit": False}


def _base(**kw):
    return lambda: golden_base_scene("cpu", **kw)


def _skinned(pallas: bool):
    def build():
        r = skinned_png_scene("cpu")
        r.config.render.use_pallas = pallas
        return r
    return build


# flavor → (scene builder, whether to force the indexed geometry path)
FLAVORS = {
    "forward": (_base(), False),
    "ref": (_base(use_pallas=False), False),
    "ref_shadows": (_base(use_pallas=False, shadows=True,
                          shadow_map_size=128), False),
    "planes_f16": (_base(forward_shading=False, plane_f16=True), False),
    "planes_f32_shadows": (_base(forward_shading=False, plane_f16=False,
                                 shadows=True, shadow_map_size=128), False),
    "skinned_ref": (_skinned(False), False),
    "skinned": (_skinned(True), False),
    "indexed": (_base(), True),
    "shadows_banded": (_base(shadows=True, shadow_map_size=128), False),
    "shadows_unbanded": (_base(shadows=True, shadow_map_size=96), False),
    "pcf": (_base(shadows=True, shadow_map_size=128, shadow_pcf=True),
            False),
    "ssaa": (_base(supersample=2), False),
    "bloom": (_base(bloom=True, bloom_threshold=0.35, bloom_strength=0.8),
              False),
    "vcolor": (lambda: feature_scene("vcolor", "cpu"), False),
    "skybox": (lambda: feature_scene("skybox", "cpu"), False),
    "fuse": (_base(kernel={"fuse": True}), False),
    "ckern": (_base(shadows=True, shadow_map_size=128, kernel=CKERN), False),
    "tiled_shade": (_base(shadows=True, shadow_map_size=128, shadow_pcf=True,
                          kernel={"tiled_shade": True}), False),
    "fuse_tiled_vcolor": (lambda: feature_scene(
        "vcolor", "cpu", kernel={"fuse": True, "tiled_shade": True}), False),
}


def banded_inputs(inp: dict, indexed: bool = False, r=None) -> dict:
    """render_frame_banded's keyword arguments from render_frame's
    (Renderer.frame_inputs); `indexed` drops the corner table so a rigid
    frame takes the indexed path over the geometry's device buffers."""
    return banded_kwargs(inp, geometry_to_device(r.geometry.packed(), CPU)
                         if indexed else None)


def same_frame(a, b, n_bands: int, what: str) -> None:
    """Colour, depth bits and ids equal; every band's aux (and the light
    pass's) [0, 0]."""
    assert frame_diffs(a, b) == [], (what, frame_diffs(a, b))
    assert a.aux.tolist() == [0, 0] * n_bands, (what, a.aux.tolist())
    if b.shadow_aux is not None:
        assert not a.shadow_aux.any(), (what, a.shadow_aux.tolist())


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_banded_frame_bit_equal_to_one_device(name):
    build, indexed = FLAVORS[name]
    r = build()
    inp = r.frame_inputs()
    kw = banded_inputs(inp, indexed, r)
    one = render_frame(**(kw if indexed else inp))
    assert (one.tri_id >= 0).sum() > 500, "the scene is on screen"
    for n in (2, 4):
        out = render_frame_banded([CPU] * n, **kw)
        same_frame(out, one, n, f"{name} n={n}")
    if name == "forward":
        # n = 3: 96 rows (3 whole tiles), the 16-triangle plan padded to
        # 18 (pad triangles invalid, at the end), the indexed path
        r.config.render.height = 96
        inp = r.frame_inputs()
        kw = banded_inputs(inp, True, r)
        one = render_frame(**kw)
        same_frame(render_frame_banded([CPU] * 3, **kw), one, 3, "n=3")


def test_banded_forward_frame_in_the_jax_golden_gate():
    """The shadows_hard flavor through the Renderer with bands = 2 (its
    256² map banded over 2 as well) against the JAX package's single-chip
    frame of it (tests/test_torch_frame.py checks the golden is that
    frame)."""
    from test_torch_frame import _assert_golden_gate

    r = golden_base_scene("cpu", shadows=True, shadow_map_size=256,
                          bands=2)
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0, 0, 0]
    assert out.shadow_aux.tolist() == [0, 0, 0, 0]    # the map banded too
    _assert_golden_gate(out.color.numpy(),
                        np.load(GOLDENS / "torch_slice_shadows_hard.npy"))


def test_banded_frame_refuses_bands_that_are_not_whole_tiles():
    inp = banded_inputs(golden_base_scene("cpu").frame_inputs())
    for n in (3, 8):            # 128 / 3 leaves rows over; 16-row bands
        with pytest.raises(ValueError):
            render_frame_banded([CPU] * n, **inp)


def test_renderer_bands_render_the_one_device_frame():
    """RenderConfig.bands = 2 and 4 on the CPU: the Renderer's banded
    frame (two blobs, render_frame_banded_bundled) bit-equal to its
    bands = 1 frame; a banded frame leaves no idle-frame signature."""
    r = golden_base_scene("cpu", shadows=True, shadow_map_size=128,
                          shadow_pcf=True)
    one = r.render_viewport()
    assert r.viewports[0].last_sig is not None
    for n in (2, 4):
        r.config.render.bands = n
        out = r.render_viewport()
        same_frame(out, one, n, f"bands={n}")
        assert r.viewports[0].last_sig is None
        assert r.viewports[0].last_frame is out
        assert r.frame_bundle().key is None
    r.config.render.bands = 1
    again = r.render_viewport()
    assert again is not out and torch.equal(again.color, one.color)


def _ai_renderer(bands: int, width: int = 128, height: int = 128, **kw):
    return golden_base_scene("cpu", width=width, height=height,
                             ai_upscale=True, bands=bands, **kw)


def test_banded_ai_upscale_matches_one_device():
    """Two :ai frames (the camera orbits between them, so the second
    warps the first, an RGBA8 history, through warp_previous): each
    banded frame is the one-device half-size frame upscaled by the V1
    path on the same temporal input, bit for bit, and within
    test_parallel.py's gate of the Renderer's bands = 1 frame (V2)."""
    rb, r1 = _ai_renderer(2), _ai_renderer(1)
    for k in range(2):
        if k:
            for r in (rb, r1):
                r.editor_camera.orbit([0, 0, 0], 6.0, 4.0)
        prev = rb.prev_state
        assert (prev is None) == (k == 0)
        out = rb.render_viewport()
        inp = rb.frame_inputs()        # the camera as the frame sized it
        assert inp["width"] == 64 and inp["upscale_params"] is not None
        assert out.color.shape == (128, 128, 4) and out.history is None
        assert out.aux.tolist() == [0, 0, 0, 0]
        color, depth = one_device_v1(inp, prev)
        assert torch.equal(out.color, color), k
        assert torch.equal(out.depth.view(torch.int32),
                           depth.view(torch.int32))
        assert torch.equal(rb.prev_state[0], out.color)
        assert torch.equal(rb.prev_state[1], out.view_proj)
        one = r1.render_viewport()
        diff = (out.color.int() - one.color.int()).abs()
        assert diff.max() <= 1 and (diff > 0).float().mean() < 5e-3, k


class _Messages(logging.Handler):
    """The Renderer's log records (its loggers do not propagate)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_banded_indivisible_heights_degrade():
    """test_parallel.py's fallbacks: a half height whose bands are not
    whole tiles (192 → 96 → 48 rows a band) renders native-size bands
    (192 → 96); a native height that does not split (120 → 60) renders
    on one device, warning once; fewer cards than bands warn and render
    on one device."""
    r = _ai_renderer(2, 128, 192)
    out = r.render_viewport()
    assert out.color.shape == (192, 128, 4)
    assert out.aux.shape == (4,) and r.prev_state is None
    r.config.render.bands = 1
    one = r.render_viewport()
    assert one.aux.shape == (2,) and r.prev_state is not None
    log = logging.getLogger("trident.renderer_torch")
    seen = _Messages()
    log.addHandler(seen)
    try:
        r2 = golden_base_scene("cpu", width=128, height=120, bands=2)
        a = r2.render_viewport()
        r2.render_viewport()
        warned = [m for m in seen.messages if "does not split" in m]
        assert len(warned) == 1 and a.color.shape == (120, 128, 4)
        assert a.aux.shape == (2,)
        r2.config.render.bands = 1
        assert torch.equal(r2.render_viewport().color, a.color)
        # fewer cards than bands (none here): the JAX Renderer's warning
        r2.device = torch.device("cuda")
        r2.config.render.bands = 2
        assert r2._band_devices() is None
        assert any("but only 0 devices" in m for m in seen.messages)
    finally:
        log.removeHandler(seen)
