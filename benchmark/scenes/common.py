"""Scene building blocks on the program's public API, from a
configuration: the Renderer, the texture, the material, the light and the
camera."""

from __future__ import annotations

import os

import numpy as np

from benchmark import gen

# RenderConfig fields a configuration may set; absent, the program's own
# defaults hold. ai_upscale loads the program's shipped 2× weights
# (assets/upscaler_2x.npz); the convs' precision stays a kernel knob.
RENDER_OPTIONAL = ("ai_upscale", "shadow_map_size", "shadow_pcf", "bloom")


def render_config(cfg: dict):
    """The configuration's RenderConfig: size, clear colour, shadows,
    kernel knobs, and those of RENDER_OPTIONAL it names."""
    from trident_tpu_torch.core.config import RenderConfig

    return RenderConfig(width=cfg["width"], height=cfg["height"],
                        clear_color=tuple(cfg["clear_color"]),
                        shadows=cfg["shadows"], kernel=cfg["kernel"],
                        **{k: cfg[k] for k in RENDER_OPTIONAL if k in cfg})


def renderer(cfg: dict, device, workdir: str):
    """A Renderer at the configuration's size and settings; its frame-
    timing captures (`capture.perf_dir`) go under `workdir`, and it keeps
    no log file."""
    from trident_tpu_torch.core.config import CaptureConfig, EngineConfig
    from trident_tpu_torch.render.renderer import Renderer

    return Renderer(EngineConfig(
        render=render_config(cfg),
        capture=CaptureConfig(perf_dir=os.path.join(workdir,
                                                    "PerformanceCaptures")),
        log_file=None), device=device)


def texture(r, cfg: dict) -> int:
    """The configuration's checker in a texture slot → the slot."""
    tex = cfg["texture"]
    return r.acquire_texture("checker", gen.checker(
        tex["size"], tex["cells"], tex["color_a"], tex["color_b"]))


def material(cfg: dict):
    """The configuration's material."""
    from trident_tpu_torch.geometry.mesh import Material

    m = cfg["material"]
    return Material(base_color=tuple(m["base_color"]), metallic=m["metallic"],
                    roughness=m["roughness"], ambient_strength=m["ambient"],
                    name="benchmark")


def light(reg, cfg: dict) -> None:
    """The configuration's directional light as an entity of `reg`; it
    casts shadows where the configuration's light says `cast_shadows`."""
    from trident_tpu_torch.ecs.components import (
        LightComponent,
        LightType,
        TransformComponent,
    )

    li = cfg["light"]
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array(li["direction"], np.float32),
        color=np.array(li["color"], np.float32), intensity=li["intensity"],
        cast_shadows=bool(li.get("cast_shadows", False))))


def camera(r, cfg: dict) -> None:
    """The editor camera where the configuration puts it."""
    cam = cfg["camera"]
    r.editor_camera.set_perspective(cam["fov_deg"], cam["near"], cam["far"])
    r.editor_camera.set_position(cam["position"])
    r.editor_camera.look_at_target(cam["target"])
