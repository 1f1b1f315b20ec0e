"""Small public pieces of the JAX package the port now has, each against
its JAX counterpart:

  * ops/shading.py::sample_texture with the per-pixel texture slot and no
    size_hint: one gather of the slots' tex.sizes rows, as the JAX
    function's _level_geom gathers (trident_tpu/ops/shading.py:163-167);
    bit-equal to the call with the hint, and to the JAX function, in
    every sampling mode;
  * ops/shadow.py::null_shadow, render/frame.py::gather_sprite_draws,
    mathx/transforms.py::vulkan_flip_y, render/types.py MaterialTable,
    FramebufferConfig and zero_light_params;
  * tools_dev/kbench.py's bins: through the indexed path, vertex_stage then
    triangle_setup_cols, as the JAX script builds them (kbench.py:59-67).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.io.image import checkerboard
from trident_tpu.mathx import transforms as jtransforms
from trident_tpu.ops import shading as jshading
from trident_tpu.ops.shadow import null_shadow as j_null_shadow
from trident_tpu.render import types as jtypes
from trident_tpu.render.frame import gather_sprite_draws as j_gather
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.ecs.registry import from_reference
from trident_tpu_torch.mathx.transforms import vulkan_flip_y
from trident_tpu_torch.ops import raster, shading
from trident_tpu_torch.ops.shadow import null_shadow, shadow_factor
from trident_tpu_torch.ops.vertex import triangle_setup_cols, vertex_stage
from trident_tpu_torch.render import types
from trident_tpu_torch.render.frame import (
    geometry_to_device,
    gather_sprite_draws,
)
from trident_tpu_torch.tools_dev import kbench as kb
from trident_tpu_torch.tools_dev.scenes import build_bench_scene, rotate

from test_torch_sprite import FIELDS, _sprite_registry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def textures():
    """A JAX texture table of three slots (white, a 64² and a 16²
    checker) and the port's twin of it."""
    r = JRenderer(JEngineConfig(render=JRenderConfig(width=32, height=32)))
    r.acquire_texture("a", checkerboard(64, 8))
    r.acquire_texture("b", checkerboard(16, 2))
    jtex = r.textures.device_arrays()
    return jtex, types.from_numpy(jtex, "cpu")


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
def test_sample_texture_without_a_hint(textures, mode):
    jtex, tex = textures
    rng = np.random.default_rng(4)
    slot = rng.integers(0, 3, (24, 20)).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (24, 20, 2)).astype(np.float32)
    mip = rng.uniform(-0.5, 7.5, (24, 20)).astype(np.float32)
    t_slot, t_uv, t_mip = (torch.from_numpy(a) for a in (slot, uv, mip))
    row = tex.sizes[t_slot.long()]
    hint = tuple(row[..., k] for k in range(4))
    got = shading.sample_texture(tex, t_uv, t_mip, mode, slot=t_slot)
    with_hint = shading.sample_texture(tex, t_uv, t_mip, mode,
                                       size_hint=hint)
    assert torch.equal(got, with_hint)
    want = np.asarray(jshading.sample_texture(
        jtex, jnp.asarray(slot), jnp.asarray(uv), jnp.asarray(mip), mode))
    assert (got.numpy().view(np.int32) == want.view(np.int32)).all()
    with pytest.raises(ValueError, match="size_hint or a slot"):
        shading.sample_texture(tex, t_uv, t_mip, mode)


def test_null_shadow_matches_jax():
    j = j_null_shadow(4)
    p = null_shadow(4)
    for f in jtypes.ShadowParams._fields:
        a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert a.shape == b.shape and a.dtype == b.dtype and (a == b).all()
    # a disabled shadow lights everything
    world = torch.randn(8, 8, 3)
    assert torch.equal(shadow_factor(p, world), torch.ones(8, 8, 1))


def test_gather_sprite_draws_matches_jax():
    jreg = _sprite_registry()
    lookup = {"atlas": 9}.get
    want = j_gather(jreg, None, 4, 2.5, texture_lookup=lambda p: lookup(p, 0))
    got = gather_sprite_draws(from_reference(jreg), None, 4, 2.5,
                              texture_lookup=lambda p: lookup(p, 0))
    assert isinstance(got, list) and len(got) == len(want) == 6
    for g, w in zip(got, want):
        for f in FIELDS:
            assert (np.asarray(getattr(g, f))
                    == np.asarray(getattr(w, f))).all(), f


def test_vulkan_flip_y_matches_jax():
    proj = np.arange(32, dtype=np.float32).reshape(2, 4, 4) + 1.0
    want = jtransforms.vulkan_flip_y(proj)
    assert (vulkan_flip_y(proj) == want).all()
    t = torch.from_numpy(proj.copy())
    out = vulkan_flip_y(t)
    assert isinstance(out, torch.Tensor) and (out.numpy() == want).all()
    assert torch.equal(t, torch.from_numpy(proj))     # a copy
    assert (np.asarray(jtransforms.vulkan_flip_y(jnp.asarray(proj)))
            == want).all()


def test_render_types_match_jax():
    assert types.MaterialTable._fields == jtypes.MaterialTable._fields
    assert types.FramebufferConfig._fields == \
        jtypes.FramebufferConfig._fields
    assert types.FramebufferConfig(64, 32) == tuple(
        jtypes.FramebufferConfig(64, 32))
    mt = jtypes.MaterialTable(params=np.ones((3, 8), np.float32),
                              texture_slot=np.arange(3, dtype=np.int32))
    pt = types.from_numpy(mt, "cpu")
    assert isinstance(pt, types.MaterialTable)
    assert pt.texture_slot.dtype == torch.int32
    j, p = jtypes.zero_light_params(), types.zero_light_params()
    assert isinstance(p, types.LightParams)
    for f in jtypes.LightParams._fields:
        a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert a.shape == b.shape and a.dtype == b.dtype and (a == b).all()


def test_kbench_bins_come_through_the_indexed_path():
    """kbench's frame_bins bins the setup of vertex_stage +
    triangle_setup_cols over the geometry's device buffers, bit for bit;
    K1's frame on them is the corner-stage frame's but for rounding at
    a few silhouette pixels (the two paths round the clip coordinates in
    different orders)."""
    r, reg = build_bench_scene(2, "cpu")
    rotate(reg, 0)
    r.config.render.width, r.config.render.height = 256, 160
    cs, _records, bins, w, h = kb.frame_bins(r)
    inp = r.frame_inputs()
    verts = vertex_stage(geometry_to_device(r.geometry.packed(), "cpu"),
                         inp["plan"], inp["params"], inp["camera"],
                         inp["palette"], skinned=False)
    setup, cols = triangle_setup_cols(verts.clip, inp["plan"].tri_vtx,
                                      inp["plan"].tri_valid, w, h)
    for f in ("edge", "z", "w", "bbox", "valid"):
        assert torch.equal(getattr(cs.setup, f), getattr(setup, f)), f
    ref = raster.build_bins(setup, w, h, setup_cols=cols)
    assert torch.equal(bins.pair_mask, ref.pair_mask)
    from trident_tpu_torch.render.renderer import frame_geometry

    ccs, _rec = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    corner = raster.build_bins(ccs.setup, w, h, setup_cols=ccs.cols.setup)
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    _d, t_i = raster.visibility_tiles(bins, ntx, ntx * nty)
    _d, t_c = raster.visibility_tiles(corner, ntx, ntx * nty)
    covered = int((t_c >= 0).sum())
    assert covered > 5000
    assert int((t_i != t_c).sum()) <= covered // 1000
