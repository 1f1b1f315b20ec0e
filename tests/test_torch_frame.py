"""The whole forward frame: trident_tpu_torch's Renderer against the JAX
package's `_render_frame_impl(raster="pallas")` (interpreted on CPU).

Both frames are held to the golden gate of test_golden_flavors.py: fewer
than 0.2% of the RGBA8 values off by more than 3 LSB, and a mean absolute
difference below 0.35. The committed reference frames
— tests/goldens/torch_slice_cube256.npy, the JAX package's frame of
__graft_entry__.entry(), torch_slice_{shadows_hard,shadows_pcf,bloom,
ssaa}.npy, its op-by-op frames of the post and shadow flavors, and
torch_slice_ai_upscale.npy, its two op-by-op AI-upscaled frames, and
torch_slice_knobs_{fuse_tiled,ckern,tiled_pcf}.npy, its op-by-op frames of
the kernel-knob flavors (KNOB_FLAVORS: the `_base` scene at 128² with
RenderConfig.kernel set), and torch_slice_<feature>.npy, its op-by-op
frames of the forward frame's feature flavors (write_feature_references:
vertex colours, skybox, trilinear, nearest, sprite, file mips, custom
shader, pallas_forward) — are what the card's smoke test (chip_smoke.py,
no jax there) compares against; they must still equal the JAX package's
output. Regenerate them all with `python tests/test_torch_frame.py`.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.ecs import (
    MeshComponent,
    Registry,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.geometry.primitives import PrimitiveType
from trident_tpu.io.image import checkerboard
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch import _build
from trident_tpu_torch.render.renderer import render_frame_entry

from test_torch_host import carry_renderer

torch.set_num_threads(1)

REFERENCE = (pathlib.Path(__file__).resolve().parent / "goldens"
             / "torch_slice_cube256.npy")


def jax_entry_frame() -> np.ndarray:
    """(256, 256, 4) uint8 frame of __graft_entry__.entry() under jax.jit."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    return np.asarray(jax.jit(fn)(*args))


def write_reference() -> None:
    np.save(REFERENCE, jax_entry_frame())


def _assert_golden_gate(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (diff > 3).mean() < 0.002, f"{(diff > 3).sum()} values drifted"
    assert diff.mean() < 0.35, f"mean drift {diff.mean():.4f}"


def test_entry_cube_matches_jax_and_reference():
    jax_frame = jax_entry_frame()
    ref = np.load(REFERENCE)
    assert ref.dtype == np.uint8 and ref.shape == (256, 256, 4)
    assert (ref == jax_frame).all(), "reference frame is stale: regenerate"
    port = render_frame_entry("cpu").numpy()
    _assert_golden_gate(port, jax_frame)
    assert ((port != port[0, 0]).any(-1)).sum() > 5000   # the cube is there


def _sphere_grid():
    """The bench scene's layout at 3×3, built on the JAX package."""
    r = JRenderer(EngineConfig(render=RenderConfig(
        width=128, height=128, use_pallas=True)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(3):
        for j in range(3):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - 1.5) * 1.4, (j - 1.5) * 1.4, 0],
                                  np.float32)
            t.rotation = np.array([12.0, 31.0, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 3 * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def _jax_frame_op_by_op(r, upscale_params=None, prev=None, ai=None):
    """The JAX package's forward frame for renderer `r`'s scene:
    `_render_frame_impl(raster="pallas")` evaluated op by op, so every
    elementwise op rounds once, as in the port (the Pallas kernels still
    run under the interpreter). Shadows, supersampling and bloom follow
    the render config, with the light camera chosen as the JAX Renderer
    chooses it. With `upscale_params` the scene renders at half size and
    the upscaler rebuilds the configured size, with `prev` = (previous
    history, previous view·proj) as its temporal input. `ai` is the JAX
    AiBlend mixed into the display frame (None: none). Sprites (drawn at
    `r.time.elapsed`), vertex colours, the sampling mode, the skybox level
    and the custom shader follow `r` as its render_viewport takes them."""
    from trident_tpu.ecs.components import (
        LightComponent,
        LightType,
        SpriteComponent,
    )
    from trident_tpu.ops.shadow import light_camera, scene_bounds
    from trident_tpu.render.frame import (
        build_draw_params,
        gather_mesh_draws,
        gather_sprite_draws,
    )
    from trident_tpu.render.lights import gather_lights
    from trident_tpu.render.renderer import _render_frame_impl

    rc = r.config.render
    r.editor_camera.set_viewport_size(rc.width, rc.height)
    records = gather_mesh_draws(r.registry, r.geometry)
    # sprites, vertex colours, the skybox level and the custom shader as
    # the JAX Renderer's render_viewport takes them
    if any(True for _ in r.registry.view(SpriteComponent)):
        quad = r.ensure_primitive(PrimitiveType.QUAD)
        records.extend(gather_sprite_draws(
            r.registry, r.geometry, quad, r.time.elapsed,
            texture_lookup=r.textures.lookup))
    packed = r.geometry.packed()
    vertex_colors = bool((packed.colors != 1.0).any())
    skybox = r._skybox_for(rc.height, r.editor_camera.fov_deg)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    light_cam, shadow_size = None, 0
    for _e, (lc,) in r.registry.view(LightComponent):
        if (rc.shadows and lc.enabled and lc.cast_shadows
                and lc.light_type == LightType.DIRECTIONAL):
            light_cam = light_camera(lc.direction,
                                     *scene_bounds(records, packed))
            shadow_size = rc.shadow_map_size
            break
    half = 2 if upscale_params is not None else 1
    with jax.disable_jit():
        return _render_frame_impl(
            None, plan, tri_draw, params, palette, shade,
            r.editor_camera.params(), gather_lights(r.registry),
            r.textures.device_arrays(), skybox, ai,
            r._plan_cache.corner_table(packed), upscale_params, prev,
            width=rc.width // half, height=rc.height // half,
            clear_color=tuple(rc.clear_color),
            raster="pallas", chunk=64, skinned=False,
            light_camera=light_cam, shadow_size=shadow_size,
            shadow_pcf=rc.shadow_pcf, supersample=max(int(rc.supersample), 1),
            bloom=rc.bloom, bloom_threshold=rc.bloom_threshold,
            bloom_strength=rc.bloom_strength, sampling=rc.sampling,
            vertex_colors=vertex_colors, shader_fn=r.shader_hook.fn)


def test_sphere_grid_matches_jax_frame():
    """The bench scene's layout at 3×3 and 128², through the port's
    Renderer. The JAX reference is evaluated op by op: under jit, XLA:CPU
    contracts the corner stage's a*b + c chains into FMAs, which moves the
    edge coefficients of these few-pixel triangles by ulps and flips about
    1% of covered pixels at edges and depth ties (61 of 4704 measured)."""
    jr = _sphere_grid()
    tr = carry_renderer(jr)
    jout = _jax_frame_op_by_op(jr)
    counts = dict(_build.LAUNCHES)
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert np.asarray(jout.aux).tolist() == [0, 0]
    assert out.color.shape == (128, 128, 4) and out.color.dtype == torch.uint8
    assert int((out.tri_id >= 0).sum()) > 2000
    assert (out.tri_id.numpy() == np.asarray(jout.tri_id)).all()
    _assert_golden_gate(tr.read_frame(out), np.asarray(jout.color))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert dict(_build.LAUNCHES) == counts


# The post and shadow flavors of test_golden_flavors.py's `_base` scene
# (a textured cube over a ground slab, a shadow-casting sun) at 128² on the
# Pallas path: name → RenderConfig overrides. Each one's JAX frame is
# committed as tests/goldens/torch_slice_<name>.npy for the card's smoke
# test, which has no jax.
FLAVORS = {
    "shadows_hard": dict(shadows=True, shadow_map_size=256),
    "shadows_pcf": dict(shadows=True, shadow_map_size=256, shadow_pcf=True),
    "bloom": dict(bloom=True, bloom_threshold=0.35, bloom_strength=0.8),
    "ssaa": dict(supersample=2),
}


def _flavor_reference(name: str) -> pathlib.Path:
    return REFERENCE.parent / f"torch_slice_{name}.npy"


def _flavor_renderer(name: str, flavors=FLAVORS):
    """The `_base` scene with the flavor's config, built on the JAX
    package."""
    from test_golden_flavors import _base

    rc = dict(width=128, height=128, texture_size=64, use_pallas=True,
              **flavors[name])
    r = JRenderer(EngineConfig(render=RenderConfig(**rc)))
    r.set_active_registry(Registry())
    _base(r.registry, r)
    return r


def write_flavor_references() -> None:
    for name in FLAVORS:
        out = _jax_frame_op_by_op(_flavor_renderer(name))
        np.save(_flavor_reference(name), np.asarray(out.color))


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_flavor_matches_jax_frame(name):
    """Shadows (hard and PCF at a 256² map), bloom and 2× supersampling
    through the port's Renderer against the JAX frame evaluated op by op:
    equal triangle ids, depth within 1e-6, aux [0, 0] on the main pass
    (and the light pass), and the golden gate. The committed reference must still equal the
    JAX frame."""
    jr = _flavor_renderer(name)
    tr = carry_renderer(jr)
    jout = _jax_frame_op_by_op(jr)
    jcolor = np.asarray(jout.color)
    ref = np.load(_flavor_reference(name))
    assert ref.dtype == np.uint8 and ref.shape == (128, 128, 4)
    assert (ref == jcolor).all(), "reference frame is stale: regenerate"
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert np.asarray(jout.aux).tolist() == [0, 0]
    if FLAVORS[name].get("shadows"):
        assert out.shadow_aux.tolist() == [0, 0]
    else:
        assert out.shadow_aux is None
    assert (out.tri_id.numpy() == np.asarray(jout.tri_id)).all()
    # depth within 1e-6: the interpreted JAX kernel body is compiled by
    # XLA:CPU, which contracts its edge functions into FMAs (ulps here)
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= 1e-6
    _assert_golden_gate(tr.read_frame(out), jcolor)


# The kernel-knob flavors of the same `_base` scene at 128²: name →
# RenderConfig overrides, `kernel` among them. The JAX Renderer applies its
# knobs to module globals when it is built (trident_tpu/ops/kernel_knobs.py),
# so each JAX frame is rendered with its knobs set and the env defaults are
# restored after it. Each frame is committed as
# tests/goldens/torch_slice_knobs_<name>.npy for chip_smoke.py.
KNOB_FLAVORS = {
    "fuse_tiled": dict(kernel={"fuse": True, "tiled_shade": True}),
    "ckern": dict(shadows=True, shadow_map_size=256,
                  kernel={"ckern": True, "dynhit": False}),
    "tiled_pcf": dict(shadows=True, shadow_map_size=256, shadow_pcf=True,
                      kernel={"tiled_shade": True}),
}


def _knob_reference(name: str) -> pathlib.Path:
    return REFERENCE.parent / f"torch_slice_knobs_{name}.npy"


def _jax_knob_frame(name: str):
    """(JAX Renderer, its op-by-op frame) of knob flavor `name`, the JAX
    package's knobs restored to its env defaults afterwards."""
    from trident_tpu.ops import kernel_knobs

    try:
        jr = _flavor_renderer(name, KNOB_FLAVORS)
        return jr, _jax_frame_op_by_op(jr)
    finally:
        kernel_knobs.apply(kernel_knobs.env_defaults())


def write_knob_references() -> None:
    for name in KNOB_FLAVORS:
        np.save(_knob_reference(name), np.asarray(_jax_knob_frame(name)[1]
                                                  .color))


@pytest.mark.parametrize("name", sorted(KNOB_FLAVORS))
def test_knob_flavor_matches_jax_frame(name):
    """The kernel-knob flavors through the port's Renderer (the same
    `kernel` dict) against the JAX frame evaluated op by op with those
    knobs: equal triangle ids, depth within 1e-6 (the interpreted JAX
    kernels contract FMAs), aux [0, 0] on both passes, and the golden
    gate. The committed reference must still equal the JAX frame; it is
    tests/goldens/torch_slice_knobs_<name>.npy, the JAX Renderer's frame
    of test_golden_flavors.py's `_base` scene at 128² with
    KNOB_FLAVORS[name] (`kernel` included), evaluated op by op by
    `_jax_knob_frame`; regenerate all of them with `PYTHONPATH=. python
    tests/test_torch_frame.py` (write_knob_references)."""
    jr, jout = _jax_knob_frame(name)
    tr = carry_renderer(jr)
    assert tr.config.render.kernel == KNOB_FLAVORS[name]["kernel"]
    jcolor = np.asarray(jout.color)
    ref = np.load(_knob_reference(name))
    assert ref.dtype == np.uint8 and ref.shape == (128, 128, 4)
    assert (ref == jcolor).all(), "reference frame is stale: regenerate"
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert np.asarray(jout.aux).tolist() == [0, 0]
    if KNOB_FLAVORS[name].get("shadows"):
        assert out.shadow_aux.tolist() == [0, 0]
    assert int((out.tri_id >= 0).sum()) > 2000
    assert (out.tri_id.numpy() == np.asarray(jout.tri_id)).all()
    assert np.abs(out.depth.numpy() - np.asarray(jout.depth)).max() <= 1e-6
    _assert_golden_gate(tr.read_frame(out), jcolor)


@pytest.mark.parametrize("kernel", [{"ckern": True, "dynhit": False},
                                    {"fuse": True}], ids=["ckern", "fuse"])
def test_knob_visibility_frames_equal_default_bitwise(kernel):
    """ckern and fuse change which kernels compute visibility and resolve,
    not the frame: without tiled_shade, the port's shadowed PCF frame with
    either knob equals its default-knob frame bit for bit (colour, ids,
    depth), both passes with aux [0, 0]."""
    jr = _flavor_renderer("shadows_pcf")
    base = carry_renderer(jr).render_viewport()
    knob = carry_renderer(jr, kernel=kernel).render_viewport()
    for a, b in ((knob.color, base.color), (knob.tri_id, base.tri_id),
                 (knob.depth, base.depth)):
        assert (a == b).all()
    assert knob.aux.tolist() == base.aux.tolist() == [0, 0]
    assert knob.shadow_aux.tolist() == base.shadow_aux.tolist() == [0, 0]


# The AI-upscaled frame: the `_base` scene at 128² (rendered at 64²) with
# the shipped temporal upscaler, frame 0 without history, then frame 1
# after orbit([0, 0, 0], 6, 4) with frame 0's history. The JAX frames,
# convs in f32 (its default is bf16) and the Pallas warp interpreted, are
# committed as tests/goldens/torch_slice_ai_upscale.npy, shape
# (2, 128, 128, 4).
AI_REFERENCE = REFERENCE.parent / "torch_slice_ai_upscale.npy"
AI_ORBIT = ([0.0, 0.0, 0.0], 6.0, 4.0)


def _ai_renderer():
    from test_golden_flavors import _base

    r = JRenderer(EngineConfig(render=RenderConfig(
        width=128, height=128, texture_size=64, use_pallas=True,
        ai_upscale=True)))
    r.set_active_registry(Registry())
    _base(r.registry, r)
    return r


def _jax_ai_frames(jr):
    """The JAX package's two AI-upscaled frames of `jr`'s scene (its
    camera is orbited between them)."""
    from trident_tpu.ai.upscaler import load_upscaler
    from trident_tpu.ops import kernel_knobs

    params, _bc = load_upscaler(str(pathlib.Path(__file__).resolve()
                                    .parents[1] / "assets_out" / "upscaler_2x"))
    with kernel_knobs.overrides(upscale_v2=True, upscale_dtype="f32",
                                warp_mxu=True):
        out0 = _jax_frame_op_by_op(jr, params)
        p = jr.editor_camera.params()
        vp0 = jax.numpy.matmul(p.proj, p.view,
                               precision=jax.lax.Precision.HIGHEST)
        jr.editor_camera.orbit(*AI_ORBIT)
        out1 = _jax_frame_op_by_op(jr, params, (out0.history, vp0))
    return out0, out1


def test_knob_route_reaches_the_upscaled_frame():
    """The AI-upscaled frame's half-size render takes the knob route too:
    with fuse (the fused pass, untiled attributes) both chained frames and
    their histories equal the default-knob frames bit for bit."""
    jr = _ai_renderer()
    outs = {}
    for name, kernel in (("default", None), ("fuse", {"fuse": True})):
        tr = carry_renderer(jr, kernel=kernel)
        assert tr.knobs.fuse == (kernel is not None)
        first = tr.render_viewport()
        tr.editor_camera.orbit(*AI_ORBIT)
        outs[name] = (first, tr.render_viewport())
    for a, b in zip(outs["default"], outs["fuse"]):
        assert (a.color == b.color).all() and (a.history == b.history).all()


def write_ai_reference() -> None:
    out0, out1 = _jax_ai_frames(_ai_renderer())
    np.save(AI_REFERENCE, np.stack([np.asarray(out0.color),
                                    np.asarray(out1.color)]))


def test_ai_upscale_matches_jax_frames():
    """Two chained AI-upscaled frames through the port's Renderer (its
    default weights, the same checkpoint) against the JAX frames: aux
    [0, 0], the history's shape and dtype, the golden gate, and a real
    temporal input on frame 1 (≥ 1% of its pixels valid)."""
    from trident_tpu_torch.ai import upscaler as up

    jr = _ai_renderer()
    tr = carry_renderer(jr)
    jouts = _jax_ai_frames(jr)
    ref = np.load(AI_REFERENCE)
    assert ref.dtype == np.uint8 and ref.shape == (2, 128, 128, 4)
    assert all((ref[k] == np.asarray(o.color)).all()
               for k, o in enumerate(jouts)), "reference is stale: regenerate"
    out0 = tr.render_viewport()
    prev0 = tr.prev_state
    tr.editor_camera.orbit(*AI_ORBIT)
    out1 = tr.render_viewport()
    for k, (out, jout) in enumerate(zip((out0, out1), jouts)):
        assert out.aux.tolist() == [0, 0], k
        assert np.asarray(jout.aux).tolist() == [0, 0], k
        jh = np.asarray(jout.history)
        assert tuple(out.history.shape) == jh.shape == (64, 64, 12), k
        assert out.history.dtype == torch.uint8 and jh.dtype == np.uint8, k
        assert out.color.shape == (128, 128, 4), k
        _assert_golden_gate(tr.read_frame(out), np.asarray(jout.color))
    assert (out1.history is tr.prev_state[0]) and prev0[0] is out0.history
    temporal = up.temporal_from_prev(
        tr._upscale_params(), prev0, out1.depth[::2, ::2].contiguous(),
        tr.editor_camera.params("cpu"), 128, 128)
    assert float(temporal[..., 12].mean()) >= 0.01


# The forward frame's feature flavors (vertex colours, skybox, trilinear
# and nearest sampling, a sprite, a file mip chain, a custom shader, and
# the golden PNG's pallas_forward scene): trident_tpu_torch/tools_dev/
# scenes.py::feature_scene builds each on the port, jax_feature_renderer
# its twin on the JAX package. Each JAX frame, evaluated op by op, is
# committed as tests/goldens/torch_slice_<name>.npy for chip_smoke.py.
BANDED_SHADER_JAX = """
import jax
import jax.numpy as jnp


def shade(world, normal, albedo, metallic, roughness, ambient_strength,
          camera_pos, lights, dir_shadow=None):
    l = -lights.dir_direction
    l = l * jax.lax.rsqrt(jnp.maximum(jnp.sum(l * l), 1e-8))
    ndotl = jnp.maximum(jnp.sum(normal * l, axis=-1, keepdims=True), 0.0)
    band = jnp.floor(ndotl * 3.0) * (1.0 / 3.0)
    if dir_shadow is not None:
        band = band * dir_shadow
    light = lights.dir_color[:3] * lights.dir_color[3]
    return albedo * (0.15 + band * light)
"""


def jax_feature_renderer(name: str, shader_path=None, **render_kw):
    """scenes.feature_scene(name)'s twin on the JAX package (the "shader"
    flavor writes BANDED_SHADER_JAX to `shader_path`)."""
    from test_golden_flavors import _base

    from trident_tpu.ecs.components import (
        LightComponent,
        LightType,
        SpriteComponent,
    )
    from trident_tpu.geometry.primitives import build_primitive
    from trident_tpu_torch.tools_dev import scenes

    kw = {"pallas_forward": dict(shadows=True, shadow_map_size=128),
          "trilinear": dict(sampling="trilinear"),
          "nearest": dict(sampling="nearest")}.get(name, {})
    r = JRenderer(EngineConfig(render=RenderConfig(**{
        "width": 128, "height": 128, "texture_size": 64, "use_pallas": True,
        **kw, **render_kw})))
    reg = Registry()
    r.set_active_registry(reg)
    if name == "sprite":
        slot = r.acquire_texture("atlas", scenes.sprite_atlas())
        s = reg.create()
        reg.add(s, TransformComponent())
        reg.add(s, SpriteComponent(texture_path="atlas", texture_slot=slot,
                                   atlas_tiles=2, atlas_index=1))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            light_type=LightType.DIRECTIONAL,
            direction=np.array([0.0, -0.3, -1.0], np.float32),
            intensity=3.0))
        r.editor_camera.set_position([0, 0, 2.2])
        r.editor_camera.look_at_target([0, 0, 0])
        return r
    _base(reg, r)
    cube = next(e for e, _ in reg.view(TextureComponent))
    if name == "vcolor":
        idx = r.geometry.add_mesh(scenes.coloured_mesh(
            build_primitive(PrimitiveType.CUBE)))
        reg.get(cube, MeshComponent).mesh_index = idx
    elif name == "skybox":
        r.set_skybox(scenes.gradient_faces(16))
    elif name in ("trilinear", "nearest"):
        reg.get(cube, TextureComponent).tiling = (
            9.0 if name == "trilinear" else 2.0)
    elif name == "mips":
        slot = r.textures.replace("checker", checkerboard(64, 8),
                                  mips=scenes.checker_mips(64))
        tex = reg.get(cube, TextureComponent)
        tex.slot, tex.tiling = slot, 4.0
    elif name == "shader":
        with open(shader_path, "w") as f:
            f.write(BANDED_SHADER_JAX)
        assert r.set_custom_shader(str(shader_path)), \
            r.shader_hook.last_error
    elif name != "pallas_forward":
        raise KeyError(name)
    return r


def jax_feature_frame(name: str, shader_path=None, **render_kw):
    """(JAX Renderer, its op-by-op frame) of feature flavor `name`, the JAX
    package's kernel knobs restored to its env defaults afterwards (its
    Renderer sets zskip and zorder for shadowed scenes)."""
    from trident_tpu.ops import kernel_knobs

    try:
        jr = jax_feature_renderer(name, shader_path, **render_kw)
        return jr, _jax_frame_op_by_op(jr)
    finally:
        kernel_knobs.apply(kernel_knobs.env_defaults())


def feature_reference(name: str) -> pathlib.Path:
    return REFERENCE.parent / f"torch_slice_{name}.npy"


def write_feature_references() -> None:
    import tempfile

    from trident_tpu_torch.tools_dev.scenes import FEATURE_FLAVORS

    with tempfile.TemporaryDirectory() as td:
        for name in FEATURE_FLAVORS:
            out = jax_feature_frame(name, pathlib.Path(td) / "shader.py")[1]
            np.save(feature_reference(name), np.asarray(out.color))


def check_feature_frame(name: str, tmp_path, **render_kw):
    """The port's frame of feature flavor `name` (built on the port by
    scenes.feature_scene) against the JAX frame under the golden gate,
    with aux [0, 0] on both and the triangle ids equal but for edge flips;
    the committed
    reference must still equal the JAX frame (without `render_kw`).
    Returns (port Renderer, port frame, JAX frame (numpy))."""
    from trident_tpu_torch.tools_dev.scenes import feature_scene

    jr, jout = jax_feature_frame(name, tmp_path / "jshader.py", **render_kw)
    jcolor = np.asarray(jout.color)
    if not render_kw:
        ref = np.load(feature_reference(name))
        assert ref.dtype == np.uint8 and ref.shape == (128, 128, 4)
        assert (ref == jcolor).all(), "reference frame is stale: regenerate"
    tr = feature_scene(name, "cpu", shader_path=tmp_path / "shader.py",
                       **render_kw)
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert np.asarray(jout.aux).tolist() == [0, 0]
    # the interpreted JAX kernels contract their edge functions into FMAs:
    # pixel centres on an edge may flip (a sprite's diagonal runs through
    # pixel centres), at most 1% of the covered pixels
    pt, jt = out.tri_id.numpy(), np.asarray(jout.tri_id)
    assert ((pt >= 0) == (jt >= 0)).mean() > 0.999
    assert (pt != jt).sum() <= max(32, int((jt >= 0).sum()) // 100)
    _assert_golden_gate(tr.read_frame(out), jcolor)
    return tr, out, jcolor


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    write_reference()
    print("wrote", REFERENCE)
    write_flavor_references()
    print("wrote", *(_flavor_reference(n) for n in FLAVORS))
    write_ai_reference()
    print("wrote", AI_REFERENCE)
    write_knob_references()
    print("wrote", *(_knob_reference(n) for n in KNOB_FLAVORS))
    write_feature_references()
    print("wrote feature references")
