"""Sprites on the port: gather_sprite_batch's draws (as DrawRecords)
against the JAX package's gather_sprite_draws
(trident_tpu/render/frame.py:81-113), the
flavor_sprite scene's frame against the JAX frame, and a scene of meshes
and sprites through the Renderer (meshes first, then the sprites as quads;
not uniform-stride, so the corner stage gathers the draw rows).
"""

import numpy as np
import pytest
import torch

from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.render.frame import gather_sprite_draws as j_gather

from trident_tpu_torch.ecs.components import SpriteComponent
from trident_tpu_torch.ecs.registry import from_reference
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.render.frame import gather_sprite_batch
from trident_tpu_torch.tools_dev.scenes import (
    FEATURE_SPRITES,
    build_feature_scene,
)

from test_torch_frame import check_feature_frame

torch.set_num_threads(1)

FIELDS = ("entity", "mesh_index", "model", "tint", "uv_scale", "uv_offset",
          "tiling", "texture_slot", "material_index")


def _sprite_registry():
    """A JAX registry of 7 sprites: animated 2×2 and 3×3 atlases, sort
    offsets, tints, tiling, UV transforms, a path-only texture, one hidden
    sprite and one entity without a sprite."""
    rng = np.random.default_rng(21)
    reg = JRegistry()
    for k in range(7):
        e = reg.create()
        t = reg.add(e, jc.TransformComponent())
        t.position = rng.uniform(-2, 2, 3).astype(np.float32)
        t.rotation = rng.uniform(-60, 60, 3).astype(np.float32)
        t.scale = rng.uniform(0.5, 2, 3).astype(np.float32)
        sp = jc.SpriteComponent(
            texture_path="atlas" if k % 3 == 0 else "",
            texture_slot=0 if k % 3 == 0 else k,
            atlas_tiles=2 + k % 2, atlas_index=k % 4,
            animation_speed=[0.0, 2.0, 3.5][k % 3],
            sort_offset=[0.0, 0.25, -0.5][k % 3], tiling=1.0 + k,
            visible=k != 5)
        sp.tint = rng.uniform(0, 1, 4).astype(np.float32)
        sp.uv_scale = rng.uniform(0.5, 2, 2).astype(np.float32)
        sp.uv_offset = rng.uniform(-1, 1, 2).astype(np.float32)
        reg.add(e, sp)
    reg.add(reg.create(), jc.TransformComponent())
    return reg


@pytest.mark.parametrize("elapsed", [0.3, 7.9])
def test_sprite_draws_equal_jax(elapsed):
    """The draws (model with the sort offset, UV window of the animated
    atlas tile, tint, tiling, slot by path lookup) equal the JAX ones at
    two values of time.elapsed."""
    jreg = _sprite_registry()

    def lookup(path):
        return {"atlas": 9}.get(path, 0)

    want = j_gather(jreg, None, 4, elapsed, texture_lookup=lookup)
    got = list(gather_sprite_batch(from_reference(jreg), 4, elapsed,
                                   texture_lookup=lookup))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.shape == b.shape and (a == b).all(), f
            if a.ndim:
                assert a.dtype == b.dtype, f
    batch = gather_sprite_batch(from_reference(jreg), 4, elapsed, lookup)
    assert batch.model.dtype == np.float32 and len(batch) == 6


def test_sprite_tile_advances_with_time():
    jreg = _sprite_registry()
    reg = from_reference(jreg)
    a = gather_sprite_batch(reg, 4, 0.0).uv_offset
    b = gather_sprite_batch(reg, 4, 1.0).uv_offset
    sp = [s for _e, (s,) in reg.view(SpriteComponent) if s.visible]
    moving = np.array([s.animation_speed > 0 for s in sp])
    assert (a[~moving] == b[~moving]).all()
    assert (a[moving] != b[moving]).any(-1).all()


def test_sprite_frame_matches_jax(tmp_path):
    """flavor_sprite (tile 1 of the 2×2 atlas on one quad) against the JAX
    frame: the quad shows the green tile."""
    r, out, _j = check_feature_frame("sprite", tmp_path)
    assert r.ensure_primitive(PrimitiveType.QUAD) == 0
    covered = (out.tri_id >= 0).numpy()
    assert covered.sum() > 2000
    rgb = out.color.numpy()[covered][:, :3].astype(int)
    assert (rgb[:, 1] > rgb[:, 0] + 40).mean() > 0.9


def test_meshes_and_sprites_in_one_frame():
    """build_feature_scene at a 2×2 sphere grid and 128×72: the draws are
    the spheres, then the 64 sprites as quads; the plan is not
    uniform-stride; the sprites cover pixels in front of the spheres."""
    r, _reg = build_feature_scene(2, "cpu")
    r.set_viewport(0, 128, 72)
    st = r._frame_state()
    quad = r.ensure_primitive(PrimitiveType.QUAD)
    assert st.draws.mesh_index.tolist()[-FEATURE_SPRITES ** 2:] == \
        [quad] * FEATURE_SPRITES ** 2
    assert r._stride_kwargs() == {"draw_stride": 0, "real_draws": 0}
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0]
    draw = st.tri_draw[out.tri_id.clamp_min(0).long()]
    sprite_px = ((out.tri_id >= 0) & (draw >= 4)).sum()
    assert int(sprite_px) > 100
