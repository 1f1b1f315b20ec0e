"""The sphere field on the program through the temporal 2× upscaler: the
field's entities, texture, light, camera and motion (scenes/sphere_field.py)
on a Renderer with `ai_upscale` and the net whose weights the
configuration names (`upscaler`, relative to the checkout), so that each
frame renders at half the configuration's size, warps the previous
frame's history in (the warp kernel) and is rebuilt by the net.

Each frame takes in its predecessor's history and view·proj (`given`),
and the scene keeps the colour the net read, the depth the warp read and
the net's uint8 blocks (`KEPT`), so that the reference holds the warp and
the net to the program's own input (benchmark/check.py)."""

from __future__ import annotations

import os

import numpy as np

from benchmark import gen
from benchmark.reference import upscaled_field as reference
from benchmark.scenes import common
from benchmark.scenes.sphere_field import SphereField


def renderer(cfg: dict, device, workdir: str):
    """scenes/common.py's Renderer with the configuration's upscaler
    weights."""
    from trident_tpu_torch.core.config import (
        AiConfig,
        CaptureConfig,
        EngineConfig,
    )
    from trident_tpu_torch.render.renderer import Renderer

    return Renderer(EngineConfig(
        render=common.render_config(cfg),
        capture=CaptureConfig(perf_dir=os.path.join(workdir,
                                                    "PerformanceCaptures")),
        ai=AiConfig(upscaler_path=str(reference.CHECKOUT / cfg["upscaler"])),
        log_file=None), device=device)


class UpscaledField(SphereField):
    """The live scene of a run (SphereField's), with `kept(k)` and
    `given(prev_out)`. It builds the field as SphereField does, on its own
    Renderer: scenes/common.py's names no weights file."""

    reference = reference
    KEPT = ("colour", "depth", "blocks")   # what kept(k) holds (check.py)

    def __init__(self, cfg: dict, seed: int, cycle: int, device,
                 workdir: str) -> None:
        from trident_tpu_torch.ecs.components import (
            MeshComponent,
            TextureComponent,
            TransformComponent,
        )
        from trident_tpu_torch.ecs.registry import Registry
        from trident_tpu_torch.geometry.mesh import Mesh
        from trident_tpu_torch.render.types import FrameOutput

        if "net_color" not in FrameOutput._fields:
            raise RuntimeError(
                "the program's frame does not hand out the colour its "
                "upscaler net read (FrameOutput.net_color), which the "
                "comparison holds the net to")
        if not cfg.get("ai_upscale"):
            raise ValueError(f"{cfg['name']}: an upscaled field states "
                             "ai_upscale")
        self.motion = self.motion_of(cfg, seed, cycle)
        r = self.renderer = renderer(cfg, device, workdir)
        slot = common.texture(r, cfg)
        sph = cfg["sphere"]
        m = gen.uv_sphere(sph["rings"], sph["segments"], sph["radius"])
        mesh_idx, mat_idx = r.append_meshes(
            [Mesh(m["positions"], m["indices"], normals=m["normals"],
                  uvs=m["uvs"], name="sphere")], [common.material(cfg)])
        reg = Registry()
        r.set_active_registry(reg)
        self.transforms = []
        for p in gen.field_positions(cfg["grid"], cfg["spacing"]):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(p, np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx,
                                     material_index=mat_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
            self.transforms.append(t)
        common.light(reg, cfg)
        common.camera(r, cfg)

    def kept(self, k: int) -> dict:
        """The colour the net read at step k (f32, half size), the depth
        the warp read (f32, half size: each 2×2 repeat's first) and the
        net's blocks as the next frame's history (uint8), by reference:
        the frame the Renderer drew last, whose tensors are the clones
        draw_frame handed out (the eager frame's own on the CPU), which no
        later frame writes."""
        out = self.renderer.viewports[0].last_frame
        return {"colour": out.net_color, "depth": out.depth[::2, ::2],
                "blocks": out.history}

    def given(self, prev_out) -> dict:
        """The history and view·proj the frame after `prev_out` warped
        in, by reference."""
        return {"history": prev_out.history, "view_proj": prev_out.view_proj}


SCENE = UpscaledField
