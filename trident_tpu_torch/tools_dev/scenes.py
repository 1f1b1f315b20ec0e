"""bench.py's scenes on the port: bench.py's build_scene (the sphere grid
of it and of scripts/profile_stages.py::build_scene — grid × grid UV
spheres 1.4 apart with one 128² checker, the camera on the axis at
grid·1.1 + 2 — and cube512's one textured cube), and bench.py's per-frame
rotation.
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


def build_bench_scene(grid: int, device, config: str = "spheres1080_1m",
                      ai: bool = False, kernel=None, reg=None,
                      upscaler_path=None):
    """bench.py's build_scene(config) on the port: a grid × grid sphere
    grid with the 128² checker at 1920×1080 (spheres1080_1m) or 3840×2160
    with bloom (ultra4k); shadows1080 adds the backdrop slab and the
    shadow-casting sun; grid 0 is cube512's one cube at 512², seen from
    (0, 0, 3). ai=True is bench.py's NAME:ai mode: render at half
    size and upscale with the shipped net (or the .npz at
    `upscaler_path`). `kernel` is RenderConfig.kernel.
    Given `reg` (a registry this function built for the same config), the
    new Renderer renders that registry's scene instead of a new one.
    Returns (Renderer, Registry)."""
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
        shadows=config == "shadows1080", ai_upscale=ai, kernel=kernel),
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
