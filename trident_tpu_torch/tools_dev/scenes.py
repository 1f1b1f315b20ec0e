"""bench.py's scenes on the port: bench.py's build_scene (the sphere grid
of it and of scripts/profile_stages.py::build_scene — grid × grid UV
spheres 1.4 apart with one 128² checker, the camera on the axis at
grid·1.1 + 2 — and cube512's one textured cube), and bench.py's per-frame
rotation; the plane-gather configs of two of them (PLANE_CONFIGS); the
128² golden scenes of the forward frame's features and of the repo's PNG
goldens (png_scene); and the skinned tube crowd (skinned_scene, its numpy
mesh, layout and poses shared with the JAX twin of the tests).
"""

from __future__ import annotations

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
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(
                [(i - grid / 2) * 1.4, (j - grid / 2) * 1.4, 0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
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
               "skybox", "sprite", "f16_planes")


def png_scene(name: str, device):
    """The 128² scene of PNG golden `name` (PNG_GOLDENS) on the port, with
    the JAX tests' parameters: scene_128 is tests/test_golden.py's
    build_golden_scene (reference raster, a 128² hard shadow map),
    f16_planes the Pallas raster with f16 attribute planes, and the others
    test_golden_flavors.py's flavors on the reference raster →
    Renderer."""
    if name == "scene_128":
        return golden_scene(device)
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
