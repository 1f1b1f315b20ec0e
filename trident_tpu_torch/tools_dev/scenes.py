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
