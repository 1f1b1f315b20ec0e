"""bench.py's scenes on the port: bench.py's build_scene (the sphere grid
of it and of scripts/profile_stages.py::build_scene — grid × grid UV
spheres 1.4 apart with one 128² checker, the camera on the axis at
grid·1.1 + 2 — and cube512's one textured cube), and bench.py's per-frame
rotation; the plane-gather configs of two of them (PLANE_CONFIGS); the
128² golden scenes of the forward frame's features and of the repo's PNG
goldens (png_scene); the skinned tube crowd (skinned_scene, its numpy
mesh, layout and poses shared with the JAX twin of the tests); and the
same crowd loaded and animated: one tube written as a .glb with a looping
clip (write_tube_gltf), or as binary FBX (write_tube_fbx) or COLLADA
(write_tube_dae), imported into a Scene and played (loaded_crowd), and the
flavor_skinned rig (write_rig_gltf, skinned_png_scene); spheres1080_1m's
field as one .obj (write_field_obj) with its checker as a .ktx2 with file
mips, skyboxes as PNG faces, KTX2 and KTX1 cube maps, an SVG texture, and
the field's scene from those files or from the same arrays in memory
(field_scene). Every file is written with struct, zlib, json and text
alone (no PIL).
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

# bench.py's configs (bench.py:40-41): name → sphere grid (0: cube512)
BENCH_GRIDS = {"cube512": 0, "spheres1080": 12, "spheres1080_1m": 36,
               "ultra4k": 36, "shadows1080": 12}


def build_scene(config: str, device, ai: bool = False,
                upscaler_path=None):
    """bench.py's build_scene(config) on the port → (Renderer, Registry);
    ai=True is the NAME:ai mode, with the upscaler's weights from
    `upscaler_path` (default the port's assets/upscaler_2x.npz). An
    unknown name raises SystemExit with bench.py's message
    (bench.py:42-46)."""
    if config not in BENCH_GRIDS:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}; "
                         f"expected one of {sorted(BENCH_GRIDS)} (plus ':ai')")
    return build_bench_scene(BENCH_GRIDS[config], device, config, ai=ai,
                             upscaler_path=upscaler_path)


# the plane-gather frame on two of bench.py's scenes: name → (bench
# config, RenderConfig overrides)
PLANE_CONFIGS = {
    "spheres1080_1m:planes_f16": ("spheres1080_1m",
                                  dict(forward_shading=False, plane_f16=True)),
    "spheres1080_1m:planes_f32": ("spheres1080_1m",
                                  dict(forward_shading=False,
                                       plane_f16=False)),
    "shadows1080:planes_f16": ("shadows1080",
                               dict(forward_shading=False, plane_f16=True)),
    "shadows1080:planes_f32": ("shadows1080",
                               dict(forward_shading=False, plane_f16=False)),
    "shadows1080_pcf:planes_f16": ("shadows1080",
                                   dict(forward_shading=False, plane_f16=True,
                                        shadow_pcf=True)),
}


def build_plane_scene(name: str, device, reg=None):
    """PLANE_CONFIGS[name]: its bench scene with its overrides →
    (Renderer, Registry); given `reg`, that registry's scene."""
    config, render_kw = PLANE_CONFIGS[name]
    return build_bench_scene(BENCH_GRIDS[config], device, config, reg=reg,
                             render_kw=render_kw)


def build_bench_scene(grid: int, device, config: str = "spheres1080_1m",
                      ai: bool = False, kernel=None, reg=None,
                      upscaler_path=None, render_kw=None):
    """bench.py's build_scene(config) on the port: a grid × grid sphere
    grid with the 128² checker at 1920×1080 (spheres1080_1m) or 3840×2160
    with bloom (ultra4k); shadows1080 adds the backdrop slab and the
    shadow-casting sun; grid 0 is cube512's one cube at 512², seen from
    (0, 0, 3). ai=True is bench.py's NAME:ai mode: render at half
    size and upscale with the shipped net (or the .npz at
    `upscaler_path`). `kernel` is RenderConfig.kernel, `render_kw` more
    RenderConfig overrides. Given `reg` (a registry this function built
    for the same config), the new Renderer renders that registry's scene
    instead of a new one. Returns (Renderer, Registry)."""
    from trident_tpu_torch.core.config import (
        AiConfig,
        EngineConfig,
        RenderConfig,
    )
    from trident_tpu_torch.ecs.components import (
        LightComponent,
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    w, h = {"ultra4k": (3840, 2160), "cube512": (512, 512)}.get(
        config, (1920, 1080))
    r = Renderer(EngineConfig(render=RenderConfig(
        width=w, height=h, bloom=config == "ultra4k",
        shadows=config == "shadows1080", ai_upscale=ai, kernel=kernel,
        **(render_kw or {})),
        ai=AiConfig(upscaler_path=upscaler_path)), device=device)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh_idx = r.ensure_primitive(PrimitiveType.SPHERE if grid
                                  else PrimitiveType.CUBE)
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2 if grid else 3])
    r.editor_camera.look_at_target([0, 0, 0])
    if reg is not None:
        if config == "shadows1080":
            r.ensure_primitive(PrimitiveType.CUBE)
        r.set_active_registry(reg)
        return r, reg
    reg = Registry()
    r.set_active_registry(reg)
    if not grid:
        e = reg.create()
        reg.add(e, TransformComponent())
        reg.add(e, MeshComponent(mesh_index=mesh_idx))
        reg.add(e, TextureComponent(path="checker", slot=slot))
    populate_field(reg, grid, mesh_idx, slot)
    if config == "shadows1080":
        backdrop = reg.create()
        bt = reg.add(backdrop, TransformComponent())
        bt.position = np.array([0.0, 0.0, -2.0], np.float32)
        bt.scale = np.array([grid * 1.4, grid * 1.4, 0.2], np.float32)
        cube_idx = r.ensure_primitive(PrimitiveType.CUBE)
        reg.add(backdrop, MeshComponent(mesh_index=cube_idx))
        reg.add(backdrop, TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            direction=np.array([0.35, -0.3, -1.0], np.float32),
            intensity=2.5, cast_shadows=True))
    return r, reg


def populate_field(reg, grid: int, mesh_idx: int, slot: int) -> list:
    """bench.py's grid × grid field into `reg`: spheres (mesh `mesh_idx`)
    1.4 apart in the z = 0 plane, each textured with slot `slot`; returns
    the entities."""
    from trident_tpu_torch.ecs.components import (
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )

    out = []
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(
                [(i - grid / 2) * 1.4, (j - grid / 2) * 1.4, 0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
            out.append(e)
    return out


def rotate(reg, k: int) -> None:
    """bench.py's per-frame rotation of every entity."""
    from trident_tpu_torch.ecs.components import TransformComponent

    angle = 25.0 + k * 3.0
    for _e, (t,) in reg.view(TransformComponent):
        t.rotation = np.array([angle * 0.4, angle, 0.0], np.float32)


# -- the forward frame's features (vertex colours, skybox, sampling,
# sprites, file mips, custom shaders): the 128² golden-flavor scenes the
# tests hold against the JAX package's frames, and the full-width frame of
# chip_smoke.py's phase 14

def gradient_faces(edge: int) -> np.ndarray:
    """tests/test_golden_flavors.py's flavor_skybox cube map at `edge`²
    faces: a linear 0.1 → 0.9 ramp down the rows in channel f % 3 of face
    f, 0.3 in channel (f + 1) % 3."""
    g = np.linspace(0.1, 0.9, edge, dtype=np.float32)
    faces = np.zeros((6, edge, edge, 3), np.float32)
    for f in range(6):
        faces[f, :, :, f % 3] = g[:, None]
        faces[f, :, :, (f + 1) % 3] = 0.3
    return faces


def coloured_mesh(mesh):
    """`mesh` with per-vertex colours 0.5 + 0.5·n (deterministic)."""
    mesh.colors = (0.5 + 0.5 * mesh.normals).astype(np.float32)
    return mesh


def sprite_atlas() -> np.ndarray:
    """flavor_sprite's 32² 2×2 atlas: red, green, blue and yellow tiles."""
    atlas = np.zeros((32, 32, 4), np.uint8)
    atlas[:16, :16] = (255, 40, 40, 255)
    atlas[:16, 16:] = (40, 255, 40, 255)
    atlas[16:, :16] = (40, 40, 255, 255)
    atlas[16:, 16:] = (255, 255, 40, 255)
    return atlas


def checker_mips(size: int = 64) -> list:
    """A file mip chain for a size² texture: the levels size/2 .. 1, each
    one flat colour (red, green, blue, …) so that a frame shows which
    level it sampled."""
    colours = [(220, 60, 60), (60, 200, 60), (60, 60, 220), (220, 200, 60),
               (200, 60, 200), (60, 200, 200)]
    chain, e, k = [], size // 2, 0
    while e >= 1:
        level = np.empty((e, e, 4), np.uint8)
        level[...] = (*colours[k % len(colours)], 255)
        chain.append(level)
        e, k = e // 2, k + 1
    return chain


# a custom shader module (render/shader_hook.py contract): three light
# bands of the directional light, shadowed, over a 0.15 ambient floor
BANDED_SHADER = '''
import torch


def shade(world, normal, albedo, metallic, roughness, ambient_strength,
          camera_pos, lights, dir_shadow=None):
    l = -lights.dir_direction
    l = l * torch.rsqrt(torch.clamp_min(torch.sum(l * l), 1e-8))
    ndotl = torch.clamp_min(torch.sum(normal * l, dim=-1, keepdim=True), 0.0)
    band = torch.floor(ndotl * 3.0) * (1.0 / 3.0)
    if dir_shadow is not None:
        band = band * dir_shadow
    light = lights.dir_color[:3] * lights.dir_color[3]
    return albedo * (0.15 + band * light)
'''


def golden_base_scene(device, **render_kw):
    """tests/test_golden_flavors.py's `_base` scene (a textured cube over a
    ground slab, a shadow-casting sun) at 128² on the Pallas path, with
    RenderConfig overrides `render_kw` → Renderer (its registry active)."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        LightComponent,
        LightType,
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(**{
        "width": 128, "height": 128, "texture_size": 64, "use_pallas": True,
        **render_kw})), device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    cube_idx = r.ensure_primitive(PrimitiveType.CUBE)
    cube = reg.create()
    t = reg.add(cube, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(cube, MeshComponent(mesh_index=cube_idx))
    reg.add(cube, TextureComponent(path="checker", slot=slot))
    ground = reg.create()
    tg = reg.add(ground, TransformComponent())
    tg.position = np.array([0, -0.9, 0], np.float32)
    tg.scale = np.array([5, 0.1, 5], np.float32)
    reg.add(ground, MeshComponent(mesh_index=cube_idx))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array([-0.35, -1.0, -0.25], np.float32),
        intensity=4.0, cast_shadows=True))
    r.editor_camera.set_position([1.8, 1.3, 2.8])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def _cube_entity(r):
    from trident_tpu_torch.ecs.components import TextureComponent

    return next(e for e, _ in r.registry.view(TextureComponent))


def feature_scene(name: str, device, shader_path=None, **render_kw):
    """The 128² scene of feature flavor `name` (FEATURE_FLAVORS) on the
    port → Renderer. `shader_path` is where the "shader" flavor writes
    BANDED_SHADER (required for it)."""
    from trident_tpu_torch.ecs.components import (
        MeshComponent,
        TextureComponent,
    )
    from trident_tpu_torch.geometry.primitives import (
        PrimitiveType,
        build_primitive,
    )

    if name == "sprite":
        return sprite_scene(device, **render_kw)
    kw = {"pallas_forward": dict(shadows=True, shadow_map_size=128),
          "trilinear": dict(sampling="trilinear"),
          "nearest": dict(sampling="nearest")}.get(name, {})
    r = golden_base_scene(device, **{**kw, **render_kw})
    cube = _cube_entity(r)
    if name == "vcolor":
        idx = r.geometry.add_mesh(coloured_mesh(
            build_primitive(PrimitiveType.CUBE)))
        r.registry.get(cube, MeshComponent).mesh_index = idx
    elif name == "skybox":
        r.set_skybox(gradient_faces(16))
    elif name in ("trilinear", "nearest"):
        # trilinear: strong UV minification, where the two levels mix;
        # nearest: texels a few pixels wide, where the filters differ
        r.registry.get(cube, TextureComponent).tiling = (
            9.0 if name == "trilinear" else 2.0)
    elif name == "mips":
        from trident_tpu_torch.io.image import checkerboard

        slot = r.textures.replace("checker", checkerboard(64, 8),
                                  mips=checker_mips(64))
        tex = r.registry.get(cube, TextureComponent)
        tex.slot, tex.tiling = slot, 4.0
    elif name == "shader":
        with open(shader_path, "w") as f:
            f.write(BANDED_SHADER)
        if not r.set_custom_shader(str(shader_path)):
            raise RuntimeError(f"the banded shader did not load: "
                               f"{r.shader_hook.last_error}")
    elif name != "pallas_forward":
        raise KeyError(name)
    return r


def sprite_scene(device, **render_kw):
    """tests/test_golden_flavors.py's flavor_sprite: one sprite showing
    tile 1 of the 2×2 atlas, a sun, at 128² on the Pallas path."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        LightComponent,
        LightType,
        SpriteComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(**{
        "width": 128, "height": 128, "texture_size": 64, "use_pallas": True,
        **render_kw})), device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("atlas", sprite_atlas())
    s = reg.create()
    reg.add(s, TransformComponent())
    reg.add(s, SpriteComponent(texture_path="atlas", texture_slot=slot,
                               atlas_tiles=2, atlas_index=1))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array([0.0, -0.3, -1.0], np.float32), intensity=3.0))
    r.editor_camera.set_position([0, 0, 2.2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


FEATURE_FLAVORS = ("pallas_forward", "vcolor", "skybox", "trilinear",
                   "nearest", "sprite", "mips", "shader")

FEATURE_SPRITES = 8          # an 8×8 grid of sprites in phase 14's scene


def build_feature_scene(grid: int, device, sampling: str = "trilinear",
                        kernel=None, reg=None):
    """spheres1080_1m (build_bench_scene's grid × grid spheres at
    1920×1080) with the forward frame's features: the sphere mesh with
    per-vertex colours 0.5 + 0.5·n, the gradient skybox at 256² faces with
    a 128² and a 64² level, an 8×8 grid of animated sprites (the 2×2
    atlas, cycling 2 tiles a second) in front of the spheres, and
    `sampling`. Given `reg` (a registry this function built), the new
    Renderer renders that registry's scene. Returns (Renderer,
    Registry)."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        MeshComponent,
        SpriteComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import (
        PrimitiveType,
        build_primitive,
    )
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=1920, height=1080, sampling=sampling, kernel=kernel)),
        device=device)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    atlas = r.acquire_texture("atlas", sprite_atlas())
    mesh_idx = r.geometry.add_mesh(coloured_mesh(
        build_primitive(PrimitiveType.SPHERE)))
    r.ensure_primitive(PrimitiveType.QUAD)
    r.set_skybox(gradient_faces(256),
                 mips=[gradient_faces(128), gradient_faces(64)])
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    if reg is not None:
        r.set_active_registry(reg)
        return r, reg
    reg = Registry()
    r.set_active_registry(reg)
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(
                [(i - grid / 2) * 1.4, (j - grid / 2) * 1.4, 0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    n = FEATURE_SPRITES
    for i in range(n):
        for j in range(n):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - (n - 1) / 2) * grid * 0.15,
                                   (j - (n - 1) / 2) * grid * 0.15, 2.0],
                                  np.float32)
            t.scale = np.array([2.0, 2.0, 1.0], np.float32)
            reg.add(e, SpriteComponent(texture_path="atlas",
                                       texture_slot=atlas, atlas_tiles=2,
                                       atlas_index=(i + j) % 4,
                                       animation_speed=2.0))
    return r, reg


# -- the repo's PNG goldens (tests/test_golden.py: scene_128.png;
# tests/test_golden_flavors.py: flavor_<name>.png) on the port's
# plane-gather routes

PNG_GOLDENS = ("scene_128", "shadows_pcf", "ssaa", "bloom", "trilinear",
               "skybox", "sprite", "f16_planes", "skinned")


def png_scene(name: str, device):
    """The 128² scene of PNG golden `name` (PNG_GOLDENS) on the port, with
    the JAX tests' parameters: scene_128 is tests/test_golden.py's
    build_golden_scene (reference raster, a 128² hard shadow map),
    f16_planes the Pallas raster with f16 attribute planes, skinned the
    glTF rig imported, played and posed through a Scene
    (skinned_png_scene), and the others test_golden_flavors.py's flavors
    on the reference raster → Renderer."""
    if name == "scene_128":
        return golden_scene(device)
    if name == "skinned":
        return skinned_png_scene(device)
    if name == "f16_planes":
        return golden_base_scene(device, use_pallas=True,
                                 forward_shading=False, plane_f16=True)
    kw = {"shadows_pcf": dict(shadows=True, shadow_map_size=128,
                              shadow_pcf=True),
          "ssaa": dict(supersample=2),
          "bloom": dict(bloom=True, bloom_threshold=0.35,
                        bloom_strength=0.8)}
    if name in kw:
        return golden_base_scene(device, use_pallas=False, **kw[name])
    if name in ("trilinear", "skybox", "sprite"):
        return feature_scene(name, device, use_pallas=False)
    raise KeyError(name)


def golden_scene(device):
    """tests/test_golden.py's build_golden_scene on the port: a textured
    cube, a sphere and a ground slab under a shadow-casting sun, 128² on
    the reference raster with a 128² shadow map → Renderer."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        LightComponent,
        LightType,
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=128, height=128, texture_size=64, use_pallas=False,
        shadows=True, shadow_map_size=128)), device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    cube = reg.create()
    t = reg.add(cube, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(cube, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(cube, TextureComponent(path="checker", slot=slot))
    sph = reg.create()
    t2 = reg.add(sph, TransformComponent())
    t2.position = np.array([1.1, 0.5, -0.4], np.float32)
    t2.scale = np.array([0.6, 0.6, 0.6], np.float32)
    reg.add(sph, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.SPHERE)))
    ground = reg.create()
    tg = reg.add(ground, TransformComponent())
    tg.position = np.array([0, -0.8, 0], np.float32)
    tg.scale = np.array([6, 0.1, 6], np.float32)
    reg.add(ground, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array([-0.35, -1.0, -0.25], np.float32),
        intensity=4.0, cast_shadows=True))
    r.editor_camera.set_position([2.2, 1.6, 3.0])
    r.editor_camera.look_at_target([0.2, 0, 0])
    return r


# -- the skinned tube crowd: grid × grid tubes, each a cylinder of
# `segments` around × `rings` along (2·segments·rings triangles) skinned to
# `bones` bones along its axis, every vertex weighted to its two nearest
# bones; per-frame bone matrices from a bend angle, computed in numpy so
# that both packages get the same pose

SKIN_GRID, SKIN_SEGMENTS, SKIN_RINGS, SKIN_BONES = 12, 64, 60, 16
TUBE_LENGTH, TUBE_RADIUS = 2.0, 0.25
SKIN_SPACING, SKIN_SCALE = 1.4, 0.6
# the 128² version the tests hold against the JAX Renderer (2 × 2 tubes of
# 16 × 8 quads with two bones each: 1,024 triangles) and chip_smoke.py
# against tests/goldens/torch_slice_skinned{,_shadow}.npy
SKINNED_128 = dict(width=128, height=128, grid=2, segments=16, rings=8,
                   bones=2, shadow_map_size=128)


def tube_mesh_arrays(segments: int = SKIN_SEGMENTS, rings: int = SKIN_RINGS,
                     bones: int = SKIN_BONES) -> dict:
    """The Mesh keyword arrays of one tube (the sphere primitive's
    vertex layout and winding, rings from the top down): positions on a
    TUBE_RADIUS cylinder along +y over [0, TUBE_LENGTH], outward normals,
    UVs, a colour ramp along the axis, and each vertex skinned to the two
    bones around its height (indices b, b + 1, weights 1 − f, f; the
    other two influences index −1 with weight 0)."""
    v = np.arange(rings + 1, dtype=np.float32) / rings
    u = np.arange(segments + 1, dtype=np.float32) / segments
    theta = u * np.float32(2.0 * np.pi)
    y = np.broadcast_to((TUBE_LENGTH * (1.0 - v))[:, None],
                        (rings + 1, segments + 1))
    cx = np.broadcast_to(np.cos(theta)[None, :], y.shape)
    cz = np.broadcast_to(np.sin(theta)[None, :], y.shape)
    positions = np.stack([TUBE_RADIUS * cx, y, TUBE_RADIUS * cz],
                         axis=-1).reshape(-1, 3)
    normals = np.stack([cx, np.zeros_like(cx), cz], axis=-1).reshape(-1, 3)
    uvs = np.stack([np.broadcast_to(u[None, :], y.shape),
                    np.broadcast_to(1.0 - v[:, None], y.shape)],
                   axis=-1).reshape(-1, 2)
    t = (y / TUBE_LENGTH).reshape(-1)
    colors = np.stack([0.4 + 0.6 * t, 0.9 - 0.5 * t, 0.5 + 0.0 * t], -1)
    pos_b = t * (bones - 1)
    b0 = np.minimum(np.floor(pos_b), max(bones - 2, 0)).astype(np.int32)
    f = (pos_b - b0).astype(np.float32)
    n = positions.shape[0]
    bone_indices = np.full((n, 4), -1, np.int32)
    bone_weights = np.zeros((n, 4), np.float32)
    bone_indices[:, 0], bone_weights[:, 0] = b0, 1.0 - f
    if bones > 1:
        bone_indices[:, 1], bone_weights[:, 1] = b0 + 1, f
    row = segments + 1
    r_grid, s_grid = np.meshgrid(np.arange(rings), np.arange(segments),
                                 indexing="ij")
    i0 = r_grid * row + s_grid
    i1 = (r_grid + 1) * row + s_grid
    i2 = (r_grid + 1) * row + s_grid + 1
    i3 = r_grid * row + s_grid + 1
    indices = np.stack([i0, i2, i1, i0, i3, i2], -1).reshape(-1)
    return dict(positions=positions.astype(np.float32),
                indices=indices.astype(np.int32),
                normals=normals.astype(np.float32),
                colors=colors.astype(np.float32),
                uvs=uvs.astype(np.float32), bone_indices=bone_indices,
                bone_weights=bone_weights)


def tube_bone_matrices(bend: float, bones: int = SKIN_BONES) -> np.ndarray:
    """(bones, 4, 4) f32 skinning matrices of a tube bent by `bend`
    radians about z, spread evenly over its joints: bone b turns by
    θ_b = bend·b/(bones − 1) about its joint p_b, the chain's end after
    b segments, so M_b = T(p_b)·R(θ_b)·T(−y_b) (y_b its bind height).
    bend 0 gives identities."""
    seg = TUBE_LENGTH / max(bones - 1, 1)
    out = np.zeros((bones, 4, 4), np.float64)
    p = np.zeros(3)
    for b in range(bones):
        th = bend * b / max(bones - 1, 1)
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        out[b, :3, :3] = rot
        out[b, :3, 3] = p - rot @ np.array([0.0, b * seg, 0.0])
        out[b, 3, 3] = 1.0
        p = p + rot @ np.array([0.0, seg, 0.0])
    return out.astype(np.float32)


def tube_layout(grid: int) -> list:
    """(position, scale) of each tube of a grid × grid crowd in creation
    order: SKIN_SPACING apart in x and y, centred on the origin, each
    scaled by SKIN_SCALE and standing on its base."""
    half = (grid - 1) / 2.0
    return [(np.array([(i - half) * SKIN_SPACING,
                       (j - half) * SKIN_SPACING
                       - 0.5 * TUBE_LENGTH * SKIN_SCALE, 0.0], np.float32),
             np.full(3, SKIN_SCALE, np.float32))
            for i in range(grid) for j in range(grid)]


def tube_poses(n_tubes: int, k: int, bones: int = SKIN_BONES) -> list:
    """Frame k's bone matrices of each of n_tubes tubes: bend
    0.9·sin(0.35·k + 0.7·i) for tube i."""
    return [tube_bone_matrices(0.9 * np.sin(0.35 * k + 0.7 * i), bones)
            for i in range(n_tubes)]


def skinned_scene(device, grid: int = SKIN_GRID, width: int = 1920,
                  height: int = 1080, segments: int = SKIN_SEGMENTS,
                  rings: int = SKIN_RINGS, bones: int = SKIN_BONES,
                  shadows: bool = False, shadow_map_size: int = 1024,
                  **render_kw):
    """The skinned tube crowd on the port → (Renderer, Registry): grid ×
    grid tubes (tube_layout) with one 128² checker and frame 0's pose
    (tube_poses; pose_skinned sets another frame's), seen from the axis at
    grid·1.1 + 2; with `shadows` a backdrop slab behind them and a
    shadow-casting sun, shadow_map_size² map. The defaults are the 1080p
    crowd: 144 tubes of 7,680 triangles (1,105,920) and 16 bones each
    (2,304). `render_kw` are more RenderConfig overrides."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        AnimationComponent,
        LightComponent,
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.mesh import Mesh
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(**{
        "width": width, "height": height, "shadows": shadows,
        "shadow_map_size": shadow_map_size, **render_kw})), device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh_idx = r.geometry.add_mesh(Mesh(**tube_mesh_arrays(segments, rings,
                                                           bones)))
    for (pos, scale), mats in zip(tube_layout(grid),
                                  tube_poses(grid * grid, 0, bones)):
        e = reg.create()
        t = reg.add(e, TransformComponent())
        t.position, t.scale = pos, scale
        reg.add(e, MeshComponent(mesh_index=mesh_idx))
        reg.add(e, TextureComponent(path="checker", slot=slot))
        reg.add(e, AnimationComponent(bone_matrices=mats))
    if shadows:
        backdrop = reg.create()
        bt = reg.add(backdrop, TransformComponent())
        bt.position = np.array([0.0, 0.0, -1.0], np.float32)
        bt.scale = np.array([grid * SKIN_SPACING + 1.0,
                             grid * SKIN_SPACING + 1.0, 0.2], np.float32)
        reg.add(backdrop, MeshComponent(
            mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
        reg.add(backdrop, TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            direction=np.array([0.35, -0.3, -1.0], np.float32),
            intensity=2.5, cast_shadows=True))
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg


def pose_skinned(reg, k: int, bones: int = SKIN_BONES) -> None:
    """Frame k's pose (tube_poses) on every tube of a skinned_scene
    registry, in creation order."""
    from trident_tpu_torch.ecs.components import AnimationComponent

    anims = [a for _e, (a,) in reg.view(AnimationComponent)]
    for anim, mats in zip(anims, tube_poses(len(anims), k, bones)):
        anim.bone_matrices = mats


# -- loaded, animated scenes: model files written with struct and json
# alone (no PIL), imported through assets/scene_loader.py and posed by the
# Scene's AnimationSystem

TUBE_CLIP_SECONDS = 2.0
TUBE_KEYS = 24


def _gltf_buffer(arrays: list) -> tuple:
    """(blob, bufferViews) of numpy arrays laid end to end, each view
    4-byte aligned."""
    blob, views = b"", []
    for a in arrays:
        blob += b"\0" * (-len(blob) % 4)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        blob += a.tobytes()
    return blob + b"\0" * (-len(blob) % 4), views


def write_rig_gltf(directory) -> str:
    """tests/test_assets.py::make_skinned_gltf's two-bone quad strip and
    its 1 s clip rotating bone 1, written to `directory`/rig.gltf (one
    data-URI buffer) byte for byte as that helper writes it → the path.
    The rig of the flavor_skinned PNG golden."""
    import base64
    import json
    import os

    positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    normals = np.tile([0, 0, 1], (4, 1)).astype(np.float32)
    joints = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.uint16)
    weights = np.array([[1, 0, 0, 0]] * 4, np.float32)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    inv_binds = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    inv_binds[1, 1, 3] = -1.0  # joint1 sits at y=1
    ibm = inv_binds.transpose(0, 2, 1).reshape(-1)   # column-major
    times = np.array([0.0, 1.0], np.float32)
    # rotation of joint1: identity → 90° about z (xyzw)
    rots = np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], np.float32)
    arrays = [positions, normals, joints, weights, indices, ibm, times, rots]
    blob = b"".join(a.tobytes() for a in arrays)
    offsets = np.cumsum([0] + [a.nbytes for a in arrays[:-1]]).tolist()
    kinds = [(5126, "VEC3"), (5126, "VEC3"), (5123, "VEC4"), (5126, "VEC4"),
             (5123, "SCALAR"), (5126, "MAT4"), (5126, "SCALAR"),
             (5126, "VEC4")]
    counts = [4, 4, 4, 4, 6, 2, 2, 2]
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"name": "root_joint", "children": [1]},
            {"name": "tip_joint", "translation": [0, 1, 0]},
            {"name": "meshnode", "mesh": 0, "skin": 0},
        ],
        "skins": [{"joints": [0, 1], "inverseBindMatrices": 5}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "JOINTS_0": 2, "WEIGHTS_0": 3},
            "indices": 4,
        }]}],
        "animations": [{
            "name": "bend",
            "samplers": [{"input": 6, "output": 7, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 1, "path": "rotation"}}],
        }],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": a.nbytes}
                        for o, a in zip(offsets, arrays)],
        "accessors": [{"bufferView": i, "componentType": ct, "count": n,
                       "type": kind}
                      for i, ((ct, kind), n) in enumerate(zip(kinds, counts))],
    }
    path = os.path.join(str(directory), "rig.gltf")
    with open(path, "w") as f:
        f.write(json.dumps(doc))
    return path


def skinned_png_scene(device):
    """tests/test_golden_flavors.py's flavor_skinned on the port → the
    Renderer with the played scene's runtime registry active: write_rig_
    gltf's rig imported through import_model_entities into a Scene, its
    clip played without looping under a sun, 128² on the reference
    raster, posed by Scene.update(0.0) then update(0.5) (half bent)."""
    import tempfile

    from trident_tpu_torch.assets.scene_loader import import_model_entities
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        AnimationComponent,
        LightComponent,
        LightType,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.scene import Scene
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=128, height=128, texture_size=64, use_pallas=False)),
        device=device)
    scene = Scene(renderer=r)
    reg = scene.editor_registry
    r.set_active_registry(reg)
    with tempfile.TemporaryDirectory() as td:
        path = write_rig_gltf(td)
        ents = import_model_entities(path, reg, r)
        reg.add(ents[0], AnimationComponent(
            skeleton_asset=path, animation_asset=path, clip_index=0,
            playing=True, looping=False))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            light_type=LightType.DIRECTIONAL,
            direction=np.array([0.2, -0.4, -1.0], np.float32),
            intensity=3.0))
        r.editor_camera.set_position([0.4, 0.9, 3.2])
        r.editor_camera.look_at_target([0.2, 0.9, 0])
        scene.play()
        r.set_active_registry(scene.runtime_registry)
        scene.update(0.0)
        scene.update(0.5)       # half-bent pose
    return r


def tube_key_bends(keys: int = TUBE_KEYS):
    """(times (keys,), bends (keys,)) of write_tube_gltf's clip: key k at
    TUBE_CLIP_SECONDS·k/(keys − 1) bends the tube by 0.9·sin(2πk/keys)."""
    k = np.arange(keys)
    return ((TUBE_CLIP_SECONDS * k / (keys - 1)).astype(np.float32),
            0.9 * np.sin(2.0 * np.pi * k / keys))


def tube_bend_at(t, keys: int = TUBE_KEYS):
    """The bend of write_tube_gltf's clip at clip time(s) t: the linear
    interpolation of the key bends (the slerp of two turns about one axis
    is the lerp of their angles)."""
    times, bends = tube_key_bends(keys)
    return np.interp(np.asarray(t, np.float64), times.astype(np.float64),
                     bends)


def write_tube_gltf(path, bones: int = SKIN_BONES, keys: int = TUBE_KEYS,
                    segments: int = SKIN_SEGMENTS,
                    rings: int = SKIN_RINGS) -> str:
    """One skinned tube as a .glb at `path` → the path, written with
    struct and json alone: tube_mesh_arrays' mesh (POSITION, NORMAL,
    TEXCOORD_0, COLOR_0, JOINTS_0 / WEIGHTS_0 with the −1 influences as
    joint 0 at weight 0; each triangle's winding reversed, which the glTF
    loader reverses back), a chain of `bones` joints up +y (joint 0 at the
    base, each next one TUBE_LENGTH/(bones − 1) above) with its inverse
    binds, and one looping clip "bend" of `keys` rotation keys over
    TUBE_CLIP_SECONDS: key k turns every joint but the root about z by
    bend_k/(bones − 1) (tube_key_bends), so bone b turns by
    bend·b/(bones − 1): the pose of tube_bone_matrices(bend)."""
    import json
    import struct

    arrs = tube_mesh_arrays(segments, rings, bones)
    joints = np.maximum(arrs["bone_indices"], 0).astype(np.uint16)
    tri = arrs["indices"].reshape(-1, 3)[:, ::-1]
    indices = np.ascontiguousarray(tri).reshape(-1).astype(np.uint32)
    seg = TUBE_LENGTH / max(bones - 1, 1)
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (bones, 1, 1))
    inv_bind[:, 1, 3] = -seg * np.arange(bones, dtype=np.float32)
    times, bends = tube_key_bends(keys)
    half = bends / max(bones - 1, 1) / 2.0
    rots = np.stack([np.zeros(keys), np.zeros(keys), np.sin(half),
                     np.cos(half)], -1).astype(np.float32)      # xyzw
    arrays = [arrs["positions"], arrs["normals"], arrs["uvs"],
              arrs["colors"], joints, arrs["bone_weights"], indices,
              np.ascontiguousarray(inv_bind.transpose(0, 2, 1)), times, rots]
    blob, views = _gltf_buffer(arrays)
    v = arrs["positions"].shape[0]
    kinds = [(5126, v, "VEC3"), (5126, v, "VEC3"), (5126, v, "VEC2"),
             (5126, v, "VEC3"), (5123, v, "VEC4"), (5126, v, "VEC4"),
             (5125, indices.size, "SCALAR"), (5126, bones, "MAT4"),
             (5126, keys, "SCALAR"), (5126, keys, "VEC4")]
    accessors = [{"bufferView": i, "componentType": ct, "count": n,
                  "type": kind} for i, (ct, n, kind) in enumerate(kinds)]
    accessors[0].update(min=arrs["positions"].min(0).tolist(),
                        max=arrs["positions"].max(0).tolist())
    accessors[8].update(min=[float(times[0])], max=[float(times[-1])])
    nodes = [{"name": f"joint{j}",
              "translation": [0.0, seg if j else 0.0, 0.0],
              **({"children": [j + 1]} if j + 1 < bones else {})}
             for j in range(bones)]
    nodes.append({"name": "tube", "mesh": 0, "skin": 0})
    doc = {
        "asset": {"version": "2.0", "generator": "trident_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0, bones]}],
        "nodes": nodes,
        "skins": [{"joints": list(range(bones)), "inverseBindMatrices": 7}],
        "meshes": [{"name": "tube", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                           "COLOR_0": 3, "JOINTS_0": 4, "WEIGHTS_0": 5},
            "indices": 6}]}],
        "animations": [{
            "name": "bend",
            "samplers": [{"input": 8, "output": 9,
                          "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0,
                          "target": {"node": j, "path": "rotation"}}
                         for j in range(1, bones)]}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    text = json.dumps(doc).encode()
    text += b" " * (-len(text) % 4)
    glb = (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(text) + 8
                       + len(blob))
           + struct.pack("<II", len(text), 0x4E4F534A) + text
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(glb)
    return str(path)


class LoadedCrowd(NamedTuple):
    scene: object          # ecs/scene.py::Scene, playing
    renderer: object       # its Renderer, the runtime registry active
    entities: list         # the tubes' editor entities, in layout order
    import_ms: float       # host ms of the one import_model_entities call


def loaded_crowd(device, path, grid: int = SKIN_GRID, shadows: bool = False,
                 width: int = 1920, height: int = 1080,
                 shadow_map_size: int = 1024) -> LoadedCrowd:
    """skinned_scene's crowd, loaded and animated: `path` (a
    write_tube_gltf, write_tube_fbx or write_tube_dae file) imported once through import_model_entities into
    a Scene, grid² − 1 more entities sharing its mesh, all in the
    tube_layout(grid) grid with the 128² checker (each a TextureComponent,
    as in skinned_scene) and AnimationComponent(skeleton_asset=path,
    animation_asset=path, clip_index=0, looping=True, speed=0.6 + 0.01·i)
    so that their clip times differ; with `shadows` skinned_scene's
    backdrop and sun. Scene.play() has run: its AnimationSystem poses the
    tubes on the renderer's device. The defaults are the 1080p crowd of
    skinned_scene: 144 tubes, 1,105,920 triangles, 2,304 bones."""
    import time

    from trident_tpu_torch.assets.scene_loader import import_model_entities
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        AnimationComponent,
        LightComponent,
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.scene import Scene
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=width, height=height, shadows=shadows,
        shadow_map_size=shadow_map_size)), device=device)
    scene = Scene(renderer=r)
    reg = scene.editor_registry
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    t0 = time.perf_counter()
    first = import_model_entities(str(path), reg, r)
    import_ms = (time.perf_counter() - t0) * 1e3
    if len(first) != 1:
        raise ValueError(f"{path}: {len(first)} meshes, expected one tube")
    mesh0 = reg.get(first[0], MeshComponent)
    entities = []
    for i, (pos, scale) in enumerate(tube_layout(grid)):
        e = first[0] if i == 0 else reg.create()
        t = reg.get(e, TransformComponent) if i == 0 else reg.add(
            e, TransformComponent())
        t.position, t.rotation, t.scale = pos, np.zeros(3, np.float32), scale
        if i:
            reg.add(e, MeshComponent(mesh_index=mesh0.mesh_index,
                                     material_index=mesh0.material_index))
        reg.add(e, TextureComponent(path="checker", slot=slot))
        reg.add(e, AnimationComponent(
            skeleton_asset=str(path), animation_asset=str(path),
            clip_index=0, looping=True, speed=0.6 + 0.01 * i))
        entities.append(e)
    if shadows:
        backdrop = reg.create()
        bt = reg.add(backdrop, TransformComponent())
        bt.position = np.array([0.0, 0.0, -1.0], np.float32)
        bt.scale = np.array([grid * SKIN_SPACING + 1.0,
                             grid * SKIN_SPACING + 1.0, 0.2], np.float32)
        reg.add(backdrop, MeshComponent(
            mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
        reg.add(backdrop, TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        reg.add(sun, LightComponent(
            direction=np.array([0.35, -0.3, -1.0], np.float32),
            intensity=2.5, cast_shadows=True))
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    scene.play()
    return LoadedCrowd(scene, r, entities, import_ms)



# -- the same tube as FBX and COLLADA, written with struct, zlib and text
# alone: each file carries write_tube_gltf's mesh (vertex colours
# included), joints, inverse binds and clip, laid out so that the loaders'
# conventions (reversed winding, flipped V, welded corners) give back the
# .glb's mesh, its triangle and vertex order included

FBX_VERSION = 7400
FBX_KTIME_PER_SECOND = 46186158000      # FBX time ticks per second


def _fbx_prop(p) -> bytes:
    """One FBX property record: np.int64 → L, bool → C, int → I, float →
    D, str → S, bytes → R, a numpy array → its array type (zlib-compressed
    above 16 values, as exporters write them)."""
    if isinstance(p, np.int64):
        return b"L" + struct.pack("<q", int(p))
    if isinstance(p, bool):
        return b"C" + struct.pack("<B", int(p))
    if isinstance(p, int):
        return b"I" + struct.pack("<i", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        raw = p.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    if isinstance(p, (bytes, bytearray)):
        return b"R" + struct.pack("<I", len(p)) + bytes(p)
    arr = np.ascontiguousarray(p)
    code = {np.dtype(np.float32): b"f", np.dtype(np.float64): b"d",
            np.dtype(np.int64): b"l", np.dtype(np.int32): b"i"}[arr.dtype]
    raw, enc = arr.tobytes(), 0
    if arr.size > 16:
        raw, enc = zlib.compress(raw), 1
    return code + struct.pack("<III", arr.size, enc, len(raw)) + raw


def _fbx_node(name: str, props, children, base: int) -> bytes:
    """A node record (FBX < 7.5: 32-bit offsets) starting at file offset
    `base`: its properties, then its children closed by a null record."""
    blob = b"".join(_fbx_prop(p) for p in props)
    body, pos = b"", base + 13 + len(name) + len(blob)
    for child in children:
        sub = _fbx_node(*child, pos)
        body, pos = body + sub, pos + len(sub)
    if children:
        body, pos = body + b"\0" * 13, pos + 13
    return (struct.pack("<IIIB", pos, len(props), len(blob), len(name))
            + name.encode() + blob + body)


def write_fbx_binary(path, nodes) -> None:
    """A binary FBX 7.4 file of the top-level `nodes`, each (name, props,
    children)."""
    buf = b"Kaydara FBX Binary  \0\x1a\0" + struct.pack("<I", FBX_VERSION)
    for node in nodes:
        buf += _fbx_node(*node, len(buf))
    with open(path, "wb") as f:
        f.write(buf + b"\0" * 13)


def _fbx_p(name: str, ptype: str, label: str, flags: str, *values):
    """A Properties70 entry."""
    return ("P", [name, ptype, label, flags, *values], [])


def normalized_f32(n: np.ndarray) -> np.ndarray:
    """(N, 3) f32 rows divided by their f32 length, as the OBJ, FBX and
    COLLADA loaders normalize the normals they read."""
    n = np.asarray(n, np.float32)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def prenormalized(n: np.ndarray) -> np.ndarray:
    """Normals to write so that normalized_f32 of them is `n` (f32, (N,
    3)): n itself where that already holds, else the nearest of its
    neighbours up to 4 ulps a component that normalizes to n; n where
    none does."""
    import itertools

    n = np.asarray(n, np.float32)
    out = n.copy()
    todo = np.nonzero((normalized_f32(n) != n).any(1))[0]
    steps = sorted(itertools.product(range(-4, 5), repeat=3),
                   key=lambda d: sum(map(abs, d)))[1:]
    for step in steps:
        if not todo.size:
            break
        cand = n[todo].copy()
        for axis, d in enumerate(step):
            for _ in range(abs(d)):
                cand[:, axis] = np.nextafter(
                    cand[:, axis], np.float32(np.sign(d) * np.inf))
        ok = (normalized_f32(cand) == n[todo]).all(1)
        out[todo[ok]] = cand[ok]
        todo = todo[~ok]
    return out


def tube_file_arrays(bones: int = SKIN_BONES, keys: int = TUBE_KEYS,
                     segments: int = SKIN_SEGMENTS,
                     rings: int = SKIN_RINGS) -> dict:
    """What the FBX and COLLADA tubes store: tube_mesh_arrays' mesh with
    each triangle (a, b, c) as (a, c, b) ("corners", (T, 3): the loaders
    fan it back to (a, b, c)), normals that normalize to the .glb's
    ("file_normals", prenormalized), V flipped ("file_uvs": the loaders
    flip it back), each bone's influences ("influences": (vertex
    ids, f32 weights) of weight > 0 in vertex order, so that a vertex's
    lower bone comes first, as in the .glb), the joint spacing "seg", the
    inverse binds (B, 4, 4) f32, and the clip's key times (the .glb's f32
    times) with the turn of each joint at each key in degrees."""
    arrs = tube_mesh_arrays(segments, rings, bones)
    seg = TUBE_LENGTH / max(bones - 1, 1)
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (bones, 1, 1))
    inv_bind[:, 1, 3] = -seg * np.arange(bones, dtype=np.float32)
    times, bends = tube_key_bends(keys)
    file_uvs = arrs["uvs"].copy()
    file_uvs[:, 1] = np.float32(1.0) - file_uvs[:, 1]
    idx, wgt = arrs["bone_indices"], arrs["bone_weights"]
    influences = []
    for b in range(bones):
        v, slot = np.nonzero((idx == b) & (wgt > 0))
        influences.append((v.astype(np.int32), wgt[v, slot]))
    return dict(arrs, corners=arrs["indices"].reshape(-1, 3)[:, [0, 2, 1]],
                file_normals=prenormalized(arrs["normals"]),
                file_uvs=file_uvs, influences=influences, seg=seg,
                inv_bind=inv_bind, times=times,
                degrees=np.degrees(bends / max(bones - 1, 1)))


def write_tube_fbx(path, bones: int = SKIN_BONES, keys: int = TUBE_KEYS,
                   segments: int = SKIN_SEGMENTS,
                   rings: int = SKIN_RINGS) -> str:
    """write_tube_gltf's tube as a binary FBX 7.4 file at `path` → the
    path (tube_file_arrays): one Mesh Model over a Geometry (control
    points, triangles of reversed winding, ByPolygonVertex normals,
    IndexToDirect UVs and vertex colours), a chain of `bones` LimbNode
    Models up +y (Lcl Translation; joint 0 at the base), one Skin with a
    Cluster per joint (Indexes, Weights, Transform = the inverse bind,
    TransformLink = the bind), and one AnimationStack "bend" whose layer
    turns every joint but the root about z: an AnimationCurveNode on each
    joint's Lcl Rotation with one AnimationCurve per axis (KeyTime in FBX
    ticks at the .glb's key times, KeyValueFloat in degrees). 1 unit = 1
    m (UnitScaleFactor 100), Y up."""
    f = tube_file_arrays(bones, keys, segments, rings)
    n_v = f["positions"].shape[0]
    corners = np.ascontiguousarray(f["corners"], np.int32)
    pvi = corners.copy()
    pvi[:, 2] ^= -1                        # a polygon's last index XOR −1
    cvtx = corners.reshape(-1)
    geo, mesh_model, skin, stack, layer = (
        np.int64(x) for x in (1000, 2000, 4000, 6000, 6001))
    joint = [np.int64(3000 + j) for j in range(bones)]
    cluster = [np.int64(5000 + j) for j in range(bones)]
    rgba = np.concatenate([f["colors"], np.ones((n_v, 1), np.float32)], 1)

    def layer_element(kind, name, ref, values_name, values, index_name):
        return (kind, [0], [
            ("Version", [101], []), ("Name", [name], []),
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", [ref], []),
            (values_name, [values.astype(np.float64).reshape(-1)], []),
            *([(index_name, [cvtx], [])] if index_name else [])])

    objects = [
        ("Geometry", [geo, "tube\0\x01Geometry", "Mesh"], [
            ("Vertices", [f["positions"].astype(np.float64).reshape(-1)],
             []),
            ("PolygonVertexIndex", [pvi.reshape(-1)], []),
            ("GeometryVersion", [124], []),
            layer_element("LayerElementNormal", "", "Direct", "Normals",
                          f["file_normals"][cvtx], None),
            layer_element("LayerElementUV", "UVMap", "IndexToDirect", "UV",
                          f["file_uvs"], "UVIndex"),
            layer_element("LayerElementColor", "Col", "IndexToDirect",
                          "Colors", rgba, "ColorIndex"),
            ("Layer", [0], [("Version", [100], [])] + [
                ("LayerElement", [], [("Type", [kind], []),
                                      ("TypedIndex", [0], [])])
                for kind in ("LayerElementNormal", "LayerElementUV",
                             "LayerElementColor")]),
        ]),
        ("Model", [mesh_model, "tube\0\x01Model", "Mesh"], [
            ("Version", [232], [])]),
        ("Deformer", [skin, "\0\x01Deformer", "Skin"], [
            ("Version", [101], []), ("Link_DeformAcuracy", [50.0], [])]),
    ]
    conns = [("C", ["OO", mesh_model, np.int64(0)], []),
             ("C", ["OO", geo, mesh_model], []),
             ("C", ["OO", skin, geo], []),
             ("C", ["OO", layer, stack], [])]
    for j, (verts, weights) in enumerate(f["influences"]):
        objects.append(("Model", [joint[j], f"joint{j}\0\x01Model",
                                  "LimbNode"], [
            ("Version", [232], []),
            ("Properties70", [], [
                _fbx_p("Lcl Translation", "Lcl Translation", "", "A", 0.0,
                       f["seg"] if j else 0.0, 0.0)])]))
        inv_bind = f["inv_bind"][j].astype(np.float64)
        objects.append(("Deformer", [cluster[j], "\0\x01SubDeformer",
                                     "Cluster"], [
            ("Version", [100], []),
            ("Indexes", [verts], []),
            ("Weights", [weights.astype(np.float64)], []),
            ("Transform", [inv_bind.T.reshape(-1)], []),  # column-major
            ("TransformLink", [np.linalg.inv(inv_bind).T.reshape(-1)], [])]))
        conns += [("C", ["OO", joint[j], joint[j - 1] if j else np.int64(0)],
                   []),
                  ("C", ["OO", cluster[j], skin], []),
                  ("C", ["OO", joint[j], cluster[j]], [])]
    ticks = np.round(f["times"].astype(np.float64)
                     * FBX_KTIME_PER_SECOND).astype(np.int64)
    objects += [
        ("AnimationStack", [stack, "bend\0\x01AnimStack", ""], [
            ("Properties70", [], [
                _fbx_p("LocalStop", "KTime", "Time", "", ticks[-1]),
                _fbx_p("ReferenceStop", "KTime", "Time", "", ticks[-1])])]),
        ("AnimationLayer", [layer, "BaseLayer\0\x01AnimLayer", ""], []),
    ]
    turn = f["degrees"].astype(np.float32)
    for j in range(1, bones):
        node = np.int64(7000 + j)
        objects.append(("AnimationCurveNode",
                        [node, "R\0\x01AnimCurveNode", ""], [
            ("Properties70", [], [_fbx_p(f"d|{a}", "Number", "", "A", 0.0)
                                  for a in "XYZ"])]))
        conns += [("C", ["OO", node, layer], []),
                  ("C", ["OP", node, joint[j], "Lcl Rotation"], [])]
        for a, values in zip("XYZ", (np.zeros_like(turn),
                                     np.zeros_like(turn), turn)):
            curve = np.int64(8000 + 3 * j + "XYZ".index(a))
            objects.append(("AnimationCurve", [curve, "\0\x01AnimCurve", ""],
                            [("Default", [0.0], []), ("KeyVer", [4009], []),
                             ("KeyTime", [ticks], []),
                             ("KeyValueFloat", [values], [])]))
            conns.append(("C", ["OP", curve, node, f"d|{a}"], []))
    write_fbx_binary(path, [
        ("FBXHeaderExtension", [], [
            ("FBXHeaderVersion", [1003], []),
            ("FBXVersion", [FBX_VERSION], []),
            ("Creator", ["trident_tpu_torch tools_dev/scenes.py"], [])]),
        ("GlobalSettings", [], [
            ("Version", [1000], []),
            ("Properties70", [], [
                _fbx_p("UpAxis", "int", "Integer", "", 1),
                _fbx_p("UnitScaleFactor", "double", "Number", "", 100.0)])]),
        ("Objects", [], objects),
        ("Connections", [], conns),
    ])
    return str(path)


def _dae_floats(a) -> str:
    """Floats as text that parses back to the same doubles (repr)."""
    return " ".join(map(repr, np.asarray(a, np.float64).ravel().tolist()))


def _dae_ints(a) -> str:
    return " ".join(map(str, np.asarray(a).ravel().tolist()))


def _dae_source(sid: str, values, stride: int, params: str,
                ptype: str = "float") -> str:
    """A <source> of a float_array (a Name_array for ptype "name") with
    its accessor: `params` names the stride's fields, each of `ptype`."""
    if ptype != "name":
        n = int(np.asarray(values).size)
        array = (f'<float_array id="{sid}-array" count="{n}">'
                 f'{_dae_floats(values)}</float_array>')
    else:
        n = len(values)
        array = (f'<Name_array id="{sid}-array" count="{n}">'
                 f'{" ".join(values)}</Name_array>')
    fields = "".join(f'<param name="{p}" type="{ptype}"/>'
                     for p in params.split())
    return (f'<source id="{sid}">{array}<technique_common>'
            f'<accessor source="#{sid}-array" count="{n // stride}" '
            f'stride="{stride}">{fields}</accessor></technique_common>'
            f'</source>')


def write_tube_dae(path, bones: int = SKIN_BONES, keys: int = TUBE_KEYS,
                   segments: int = SKIN_SEGMENTS,
                   rings: int = SKIN_RINGS) -> str:
    """write_tube_gltf's tube as a COLLADA 1.4.1 document at `path` → the
    path (tube_file_arrays): one geometry whose <triangles> of reversed
    winding index positions, normals, UVs and vertex colours with one
    index a corner; a <skin> controller (identity bind shape, the joints,
    their inverse binds, each vertex's influences of weight > 0); a joint
    node chain up +y (translate, then a rotateZ of 0 degrees; joint 0 at
    the base) beside the node that instances the controller; and one
    animation a joint but the root, its rotateZ.ANGLE over the .glb's key
    times in degrees. Floats are written as repr of their doubles, so they
    read back exactly. 1 unit = 1 m, Y up."""
    f = tube_file_arrays(bones, keys, segments, rings)
    n_v, n_t = f["positions"].shape[0], f["corners"].shape[0]
    names = [f"joint{j}" for j in range(bones)]
    per_vertex = [[] for _ in range(n_v)]
    for j, (verts, weights) in enumerate(f["influences"]):
        for v, w in zip(verts.tolist(), weights.tolist()):
            per_vertex[v].append((j, w))
    weights = [w for inf in per_vertex for _j, w in inf]
    pairs, k = [], 0
    for inf in per_vertex:
        for j, _w in inf:
            pairs += [j, k]
            k += 1
    geometry = (
        '<geometry id="tube-mesh" name="tube"><mesh>'
        + _dae_source("tube-positions", f["positions"], 3, "X Y Z")
        + _dae_source("tube-normals", f["file_normals"], 3, "X Y Z")
        + _dae_source("tube-uvs", f["file_uvs"], 2, "S T")
        + _dae_source("tube-colors", f["colors"], 3, "R G B")
        + '<vertices id="tube-vertices"><input semantic="POSITION" '
          'source="#tube-positions"/></vertices>'
        + f'<triangles count="{n_t}">'
          '<input semantic="VERTEX" source="#tube-vertices" offset="0"/>'
          '<input semantic="NORMAL" source="#tube-normals" offset="0"/>'
          '<input semantic="TEXCOORD" source="#tube-uvs" offset="0" '
          'set="0"/>'
          '<input semantic="COLOR" source="#tube-colors" offset="0"/>'
        + f'<p>{_dae_ints(f["corners"])}</p></triangles></mesh></geometry>')
    controller = (
        '<controller id="tube-skin"><skin source="#tube-mesh">'
        f'<bind_shape_matrix>{_dae_floats(np.eye(4))}</bind_shape_matrix>'
        + _dae_source("tube-joints", names, 1, "JOINT", "name")
        + _dae_source("tube-binds", f["inv_bind"], 16, "TRANSFORM",
                      "float4x4")
        + _dae_source("tube-weights", np.asarray(weights, np.float32), 1,
                      "WEIGHT")
        + '<joints><input semantic="JOINT" source="#tube-joints"/>'
          '<input semantic="INV_BIND_MATRIX" source="#tube-binds"/></joints>'
        + f'<vertex_weights count="{n_v}">'
          '<input semantic="JOINT" source="#tube-joints" offset="0"/>'
          '<input semantic="WEIGHT" source="#tube-weights" offset="1"/>'
        + f'<vcount>{_dae_ints([len(i) for i in per_vertex])}</vcount>'
        + f'<v>{_dae_ints(pairs)}</v></vertex_weights></skin></controller>')
    animations = []
    for j in range(1, bones):
        a = f"joint{j}-rotateZ"
        animations.append(
            f'<animation id="{a}">'
            + _dae_source(f"{a}-input", f["times"], 1, "TIME")
            + _dae_source(f"{a}-output", f["degrees"], 1, "ANGLE")
            + _dae_source(f"{a}-interpolation", ["LINEAR"] * keys, 1,
                          "INTERPOLATION", "name")
            + f'<sampler id="{a}-sampler">'
              f'<input semantic="INPUT" source="#{a}-input"/>'
              f'<input semantic="OUTPUT" source="#{a}-output"/>'
              f'<input semantic="INTERPOLATION" '
              f'source="#{a}-interpolation"/></sampler>'
            + f'<channel source="#{a}-sampler" '
              f'target="joint{j}/rotateZ.ANGLE"/></animation>')
    chain = ""
    for j in reversed(range(bones)):
        chain = (f'<node id="joint{j}" sid="joint{j}" name="joint{j}" '
                 f'type="JOINT"><translate sid="translate">'
                 f'{_dae_floats([0.0, f["seg"] if j else 0.0, 0.0])}'
                 '</translate><rotate sid="rotateZ">0 0 1 0</rotate>'
                 f'{chain}</node>')
    doc = (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" '
        'version="1.4.1"><asset><contributor><authoring_tool>'
        'trident_tpu_torch tools_dev/scenes.py</authoring_tool>'
        '</contributor><unit name="meter" meter="1"/>'
        '<up_axis>Y_UP</up_axis></asset>'
        f'<library_geometries>{geometry}</library_geometries>'
        f'<library_controllers>{controller}</library_controllers>'
        f'<library_animations>{"".join(animations)}</library_animations>'
        '<library_visual_scenes><visual_scene id="scene">'
        f'{chain}<node id="tube" name="tube" type="NODE">'
        '<instance_controller url="#tube-skin"><skeleton>#joint0'
        '</skeleton></instance_controller></node></visual_scene>'
        '</library_visual_scenes><scene><instance_visual_scene '
        'url="#scene"/></scene></COLLADA>\n')
    with open(path, "w") as fh:
        fh.write(doc)
    return str(path)


# -- spheres1080_1m from files: its sphere field as one .obj whose .mtl
# takes the checker from a .ktx2 with its file mips, and skyboxes as six
# PNG faces, a KTX2 and a KTX1 cube map; field_scene builds the frame from
# those files or from the same arrays in memory

FIELD_MATERIAL = dict(name="field", base_color=(1.0, 1.0, 1.0, 1.0),
                      metallic=0.0, roughness=0.5)
SKY_EDGE = 256


def field_mesh_arrays(grid: int = 36) -> dict:
    """spheres1080_1m's grid × grid sphere field as one mesh's arrays (the
    sphere primitive at bench.py's positions, 1.4 apart, unrotated; 36²
    spheres of 768 triangles: 995,328), V rounded so that 1 − V is exact
    in f32 (the OBJ loaders flip V), and "file_normals": normals that
    normalized_f32 takes to the sphere's (prenormalized), so that a file
    written from these arrays loads back to them bit for bit. Keys:
    positions, normals, file_normals, uvs (f32), indices (T·3 i32, each
    sphere's Morton order)."""
    from trident_tpu_torch.geometry.primitives import build_sphere

    sphere = build_sphere()
    nv = sphere.positions.shape[0]
    ij = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                              indexing="ij"), -1).reshape(-1, 2)
    offsets = np.zeros((ij.shape[0], 3), np.float32)
    offsets[:, :2] = ((ij - grid / 2) * 1.4).astype(np.float32)
    positions = (sphere.positions[None] + offsets[:, None]).reshape(-1, 3)
    file_normals = prenormalized(sphere.normals)
    if (normalized_f32(file_normals) != sphere.normals).any():
        raise ValueError("no file normals normalize to the sphere's")
    uvs = sphere.uvs.copy()
    one = np.float32(1.0)
    uvs[:, 1] = one - (one - uvs[:, 1])
    indices = (sphere.indices[None] + nv * np.arange(ij.shape[0],
                                                     dtype=np.int32)[:, None])
    return dict(positions=positions.astype(np.float32),
                normals=np.tile(sphere.normals, (ij.shape[0], 1)),
                file_normals=np.tile(file_normals, (ij.shape[0], 1)),
                uvs=np.tile(uvs, (ij.shape[0], 1)),
                indices=indices.reshape(-1).astype(np.int32))


def write_field_obj(directory, texture: str, grid: int = 36,
                    name: str = "field") -> str:
    """field_mesh_arrays(grid) as `directory`/name.obj with name.mtl (one
    material, FIELD_MATERIAL's values, map_Kd `texture`, a file name
    beside it) → the .obj's path. Each vertex is one v / vt / vn line
    (%.9g: each f32 reads back exactly; vt holds 1 − V, vn the file
    normals), each triangle
    (a, b, c) one face a c b, which the loaders fan back to (a, b, c)."""
    import os

    f = field_mesh_arrays(grid)
    one = np.float32(1.0)
    vt = np.stack([f["uvs"][:, 0], one - f["uvs"][:, 1]], 1)
    tri = f["indices"].reshape(-1, 3)[:, [0, 2, 1]] + 1
    n_v, n_t = f["positions"].shape[0], tri.shape[0]
    m = FIELD_MATERIAL
    with open(os.path.join(str(directory), f"{name}.mtl"), "w") as fh:
        fh.write(f"newmtl {m['name']}\nKd {' '.join(map(repr, m['base_color'][:3]))}\n"
                 f"Pm {m['metallic']!r}\nPr {m['roughness']!r}\n"
                 f"map_Kd {texture}\n")
    path = os.path.join(str(directory), f"{name}.obj")
    with open(path, "w") as fh:
        fh.write(f"# {grid}x{grid} sphere field: {n_v} vertices, {n_t} "
                 f"triangles\nmtllib {name}.mtl\n")
        fh.write(("v %.9g %.9g %.9g\n" * n_v)
                 % tuple(f["positions"].astype(np.float64).ravel().tolist()))
        fh.write(("vt %.9g %.9g\n" * n_v)
                 % tuple(vt.astype(np.float64).ravel().tolist()))
        fh.write(("vn %.9g %.9g %.9g\n" * n_v)
                 % tuple(f["file_normals"].astype(np.float64).ravel()
                         .tolist()))
        fh.write(f"usemtl {m['name']}\n")
        fh.write(("f %d/%d/%d %d/%d/%d %d/%d/%d\n" * n_t)
                 % tuple(np.repeat(tri.reshape(-1), 3).tolist()))
    return path


def box_mips(rgba: np.ndarray) -> list:
    """The levels below a square power-of-two RGBA8 image, each the
    rounded mean of 2×2 texels of the one above, down to 1×1."""
    chain, cur = [], np.asarray(rgba, np.uint8)
    while cur.shape[0] > 1:
        s = (cur[0::2, 0::2].astype(np.uint16) + cur[1::2, 0::2]
             + cur[0::2, 1::2] + cur[1::2, 1::2] + 2) // 4
        cur = s.astype(np.uint8)
        chain.append(cur)
    return chain


def checker_file() -> tuple:
    """(rgba, mips): bench.py's 128² checker and the file mip chain its
    .ktx2 carries (box_mips)."""
    from trident_tpu_torch.io.image import checkerboard

    rgba = checkerboard(128, 8)
    return rgba, box_mips(rgba)


def write_checker_ktx2(path, scheme: int = 3) -> str:
    """checker_file() as a KTX2 (RGBA8, its mip chain, zlib
    supercompression by default) at `path` → the path."""
    from trident_tpu_torch.assets.ktx2 import write_ktx2

    rgba, mips = checker_file()
    write_ktx2(str(path), rgba, scheme=scheme, mips=mips)
    return str(path)


def sky_levels_u8(edge: int = SKY_EDGE) -> list:
    """The file skybox: gradient_faces as RGBA8 cube maps, (6, e, e, 4) at
    edge, edge/2, … 1 (each level the gradient at its own size)."""
    levels, e = [], edge
    while e >= 1:
        rgb = np.round(gradient_faces(e) * 255.0).astype(np.uint8)
        levels.append(np.concatenate(
            [rgb, np.full((6, e, e, 1), 255, np.uint8)], -1))
        e //= 2
    return levels


def sky_arrays(levels_u8: list) -> list:
    """RGBA8 cube-map levels as the skybox loaders return them: rgb
    float32 / 255, (6, e, e, 3) each."""
    return [lv[..., :3].astype(np.float32) / 255.0 for lv in levels_u8]


def write_sky_ktx2(path, edge: int = SKY_EDGE, scheme: int = 0) -> str:
    """sky_levels_u8(edge) as a KTX2 cube map with its mip chain."""
    from trident_tpu_torch.assets.ktx2 import write_ktx2

    levels = sky_levels_u8(edge)
    write_ktx2(str(path), levels[0], cubemap=True, scheme=scheme,
               mips=levels[1:])
    return str(path)


def write_ktx1_cubemap(path, levels_u8: list) -> str:
    """RGBA8 cube-map levels ((6, e, e, 4) each, edge halved a level) as a
    little-endian KTX1 file (GL_RGBA / GL_UNSIGNED_BYTE, imageSize one
    face's bytes, faces 4-byte aligned) → the path."""
    e = levels_u8[0].shape[1]
    head = (b"\xabKTX 11\xbb\r\n\x1a\n"
            + struct.pack("<13I", 0x04030201, 0x1401, 1, 0x1908, 0x8058,
                          0x1908, e, e, 0, 0, 6, len(levels_u8), 0))
    body = b""
    for lv in levels_u8:
        face = np.ascontiguousarray(lv, np.uint8)
        size = face[0].nbytes
        body += struct.pack("<I", size)
        for f in face:
            body += f.tobytes() + b"\0" * (-size % 4)
    with open(path, "wb") as fh:
        fh.write(head + body)
    return str(path)


def write_sky_faces(directory, edge: int = SKY_EDGE) -> str:
    """Level 0 of sky_levels_u8(edge) as six PNG faces sky_px.png …
    sky_nz.png in `directory` → the directory."""
    import os

    from trident_tpu_torch.io.image import save_png

    faces = sky_levels_u8(edge)[0]
    for face, token in zip(faces, ("px", "nx", "py", "ny", "pz", "nz")):
        save_png(os.path.join(str(directory), f"sky_{token}.png"), face)
    return str(directory)


# a 64² SVG texture: a blue ground, a stroked yellow disc, a translucent
# red triangle and a cubic stroke (rect, circle, path; fill, stroke,
# opacity)
SVG_TEXTURE = (
    '<svg xmlns="http://www.w3.org/2000/svg" width="64" height="64" '
    'viewBox="0 0 64 64">'
    '<rect width="64" height="64" fill="#2050c0"/>'
    '<circle cx="32" cy="30" r="18" fill="#f0c020" stroke="#202020" '
    'stroke-width="3"/>'
    '<path d="M6 58 L32 40 L58 58 Z" fill="#c03030" fill-opacity="0.8"/>'
    '<path d="M4 8 C20 0 44 16 60 8" fill="none" stroke="#ffffff" '
    'stroke-width="2"/></svg>')


class FieldFiles(NamedTuple):
    obj: str        # the field's .obj (its .mtl names the texture file)
    texture: str    # the texture file the .mtl names
    sky: str        # a skybox source for load_skybox_mips


def field_scene(device, grid: int = 36, width: int = 1920,
                height: int = 1080, files: FieldFiles = None,
                texture=None, sky=None):
    """spheres1080_1m's field as one mesh under one textured material
    (FIELD_MATERIAL) before a skybox, seen from bench.py's camera → (the
    Renderer, the Registry, the texture's slot). From `files`:
    import_model_entities of the .obj (load_model: the native OBJ loader
    when it builds; the texture through the .mtl and load_rgba8_mips)
    and load_skybox_mips(files.sky). Else from arrays in memory: the
    Mesh of field_mesh_arrays(grid), `texture` = (rgba, mips) through
    acquire_texture(mips=), `sky` = the skybox levels through
    set_skybox. The two differ only in where the bytes came from."""
    import os

    from trident_tpu_torch.assets.scene_loader import import_model_entities
    from trident_tpu_torch.assets.skybox import load_skybox_mips
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig
    from trident_tpu_torch.ecs.components import (
        MeshComponent,
        TransformComponent,
    )
    from trident_tpu_torch.ecs.registry import Registry
    from trident_tpu_torch.geometry.mesh import Material, Mesh
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=width,
                                                  height=height)),
                 device=device)
    reg = Registry()
    r.set_active_registry(reg)
    if files is not None:
        import_model_entities(files.obj, reg, r)
        sky = load_skybox_mips(files.sky)
        slot = r.textures.lookup(
            os.path.normpath(os.path.abspath(files.texture)))
    else:
        f = field_mesh_arrays(grid)
        from trident_tpu_torch.assets.model_loader import _compute_tangents

        tan, bit = _compute_tangents(f["positions"], f["normals"], f["uvs"],
                                     f["indices"])
        slot = r.acquire_texture("field_texture", texture[0],
                                 mips=texture[1])
        mat = Material(**FIELD_MATERIAL, base_color_texture=0)
        mat.texture_slot = slot
        mesh_base, mat_base = r.append_meshes(
            [Mesh(f["positions"], f["indices"], normals=f["normals"],
                  tangents=tan, bitangents=bit, uvs=f["uvs"],
                  name=FIELD_MATERIAL["name"])], [mat])
        e = reg.create()
        reg.add(e, TransformComponent())
        reg.add(e, MeshComponent(mesh_index=mesh_base,
                                 material_index=mat_base))
    r.set_skybox(sky[0], mips=sky[1:])
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg, slot
