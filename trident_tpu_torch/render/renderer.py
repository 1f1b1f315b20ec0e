"""The renderer: scene in, frames out (port of trident_tpu/render/renderer.py).

The default forward frame of a rigid, textured, lit scene, as the JAX
package's `_render_frame_impl(raster="pallas", forward_shading=True)` runs
it with every optional stage off:

    draw rows → corner stage (planar setup) → resolve records
    → build_bins → visibility kernel → untile
    → resolve kernel → texel kernel + PBR → RGBA8

PyTorch runs eagerly, so there is no jit, bundling or idle-frame cache;
tensors stay on the renderer's device. Shadows, bloom, supersampling,
bands, the AI upscale and blend, skyboxes, sprites, custom shaders,
non-bilinear sampling, vertex colors and skinning are not part of the
ported slice: configuring them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.core.log import get_logger
from trident_tpu.ecs.components import SpriteComponent
from trident_tpu.ecs.registry import Registry
from trident_tpu.geometry.mesh import GeometryCache
from trident_tpu.geometry.primitives import PrimitiveType, build_primitive
from trident_tpu_torch import resolve_device
from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage
from trident_tpu_torch.ops.deferred import deferred_shade_attrs, pack_rgba8
from trident_tpu_torch.ops.planes import build_resolve_cols_planar
from trident_tpu_torch.ops.raster import visibility
from trident_tpu_torch.ops.resolve import resolve_attrs
from trident_tpu_torch.render.camera import EditorCamera
from trident_tpu_torch.render.frame import (
    DrawPlanCache,
    build_draw_params,
    gather_mesh_draws,
)
from trident_tpu_torch.render.lights import gather_lights
from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.render.types import FrameOutput

logger = get_logger("renderer_torch")


def frame_geometry(plan, tri_draw, params, shade_table, camera, textures,
                   corner_t, *, width: int, height: int, draw_stride: int = 0,
                   real_draws: int = 0):
    """Per-frame geometry: (corner stage output, (RW, T) resolve records).
    The per-draw consts are the shade row + the texture sizes row, so the
    resolve kernel needs no per-pixel table lookups."""
    tex_row = textures.sizes[params.texture_slot.long()].float()
    draw_consts = torch.cat([shade_table, tex_row], dim=1)
    draw_rows = build_draw_rows(params, camera, width, height,
                                draw_consts=draw_consts)
    cs = corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid, width,
                      height, draw_stride=draw_stride, real_draws=real_draws)
    return cs, build_resolve_cols_planar(cs.cols)


def _visibility_and_shade(setup, setup_cols, records, textures, camera,
                          lights, *, width: int, height: int, clear_color):
    """Rasterize + shade a frame from prebuilt per-triangle inputs →
    (frame (H,W,4) f32, GBuffer)."""
    gbuf = visibility(setup, width, height, setup_cols=setup_cols)
    attrs = resolve_attrs(gbuf.tri_id, records)
    frame = deferred_shade_attrs(gbuf, attrs, textures, camera, lights,
                                 width, height, clear_color=clear_color)
    return frame, gbuf


def render_frame(plan, tri_draw, params, shade_table, camera, lights,
                 textures, corner_t, *, width: int, height: int, clear_color,
                 draw_stride: int = 0, real_draws: int = 0) -> FrameOutput:
    """One forward frame (the JAX `_render_frame_impl` forward branch)."""
    cs, records = frame_geometry(
        plan, tri_draw, params, shade_table, camera, textures, corner_t,
        width=width, height=height, draw_stride=draw_stride,
        real_draws=real_draws)
    frame, gbuf = _visibility_and_shade(
        cs.setup, cs.cols.setup, records, textures, camera, lights,
        width=width, height=height, clear_color=clear_color)
    return FrameOutput(color=pack_rgba8(frame), depth=gbuf.depth,
                       tri_id=gbuf.tri_id, aux=gbuf.aux)


def _check_slice(rc: RenderConfig) -> None:
    unported = {
        "use_pallas=False (reference raster)": rc.use_pallas is False,
        "forward_shading=False": not rc.forward_shading,
        "shadows": rc.shadows, "bloom": rc.bloom,
        "supersample": int(rc.supersample) != 1, "bands": rc.bands > 1,
        "ai_upscale": rc.ai_upscale,
        f"sampling={rc.sampling!r}": rc.sampling != "bilinear",
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to trident_tpu_torch yet: {', '.join(bad)}")


class Renderer:
    """Host-side scene state + the forward frame on one device."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 device=None) -> None:
        self.config = config or EngineConfig()
        rc = self.config.render
        _check_slice(rc)
        self.device = resolve_device(device)
        self.geometry = GeometryCache()
        self.textures = TextureSlots(max_slots=rc.max_textures,
                                     edge=rc.texture_size)
        self.registry: Optional[Registry] = None
        self.editor_camera = EditorCamera()
        self._plan_cache = DrawPlanCache(self.device)
        self._primitive_mesh_indices: Dict[PrimitiveType, int] = {}

    def set_active_registry(self, registry: Registry) -> None:
        self.registry = registry

    def ensure_primitive(self, kind: PrimitiveType) -> int:
        if kind not in self._primitive_mesh_indices:
            self._primitive_mesh_indices[kind] = self.geometry.add_mesh(
                build_primitive(kind))
        return self._primitive_mesh_indices[kind]

    def acquire_texture(self, key: str, rgba: Optional[np.ndarray] = None) -> int:
        return self.textures.acquire(key, rgba)

    def _stride_kwargs(self) -> dict:
        """draw_stride/real_draws for the uniform-instancing broadcast path
        (ops/corner.py), gated to ≥64k-triangle plans as in the reference."""
        stride, nd = self._plan_cache.draw_stride, self._plan_cache.real_draws
        if not stride or stride * nd < 65536:
            return {"draw_stride": 0, "real_draws": 0}
        return {"draw_stride": stride, "real_draws": nd}

    def frame_inputs(self) -> dict:
        """render_frame's arguments for the current scene, on the device,
        with the camera as it stands (render_viewport first sizes it to the
        viewport)."""
        if self.registry is None:
            raise RuntimeError("no active registry — call set_active_registry")
        if any(True for _ in self.registry.view(SpriteComponent)):
            raise NotImplementedError(
                "sprites are not ported to trident_tpu_torch yet")
        rc = self.config.render
        packed = self.geometry.packed()
        if bool((packed.colors != 1.0).any()):
            raise NotImplementedError(
                "vertex colors are not ported to trident_tpu_torch yet")
        records = gather_mesh_draws(self.registry, self.geometry)
        plan, tri_draw = self._plan_cache.plan(packed, records,
                                               self.geometry.version)
        params, shade_table = build_draw_params(
            records, plan.num_draws,
            material_table=self.geometry.material_table(), device=self.device)
        return dict(
            plan=plan, tri_draw=tri_draw, params=params,
            shade_table=shade_table,
            camera=self.editor_camera.params(self.device),
            lights=gather_lights(self.registry, self.device),
            textures=self.textures.device_arrays(self.device),
            corner_t=self._plan_cache.corner_table(packed), width=rc.width,
            height=rc.height, clear_color=tuple(rc.clear_color),
            **self._stride_kwargs())

    def render_viewport(self) -> FrameOutput:
        """Render the configured viewport with the editor camera."""
        rc = self.config.render
        self.editor_camera.set_viewport_size(rc.width, rc.height)
        return render_frame(**self.frame_inputs())

    def read_frame(self, out: Optional[FrameOutput] = None) -> np.ndarray:
        """Render (unless given a FrameOutput) and read back (H,W,4) uint8,
        warning when the raster dropped geometry."""
        if out is None:
            out = self.render_viewport()
        frame = out.color.cpu().numpy()
        if out.aux is not None and self.config.render.raster_drop_checks:
            aux = out.aux.cpu().numpy()
            if aux[0] or aux[1]:
                logger.warning(
                    "raster capacity overflow: %d pairs truncated, %d chunks "
                    "dropped — geometry is missing", int(aux[0]), int(aux[1]))
        return frame


def build_entry_renderer(width: int = 256, height: int = 256,
                         device=None) -> Renderer:
    """The scene of `__graft_entry__._build_example`: one textured cube,
    rotated (20°, 35°, 0°), seen from (0, 0, 3), default sun."""
    from trident_tpu.ecs.components import (
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu.io.image import checkerboard

    r = Renderer(EngineConfig(render=RenderConfig(width=width, height=height)),
                 device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def render_frame_entry(device=None) -> torch.Tensor:
    """Twin of `__graft_entry__.entry()`: the 256² textured lit cube through
    the forward frame → (256, 256, 4) uint8 color on `device`. Like entry(),
    it takes the camera's parameters without sizing it to the frame, so the
    projection keeps the camera's default 1920×1080 aspect."""
    return render_frame(**build_entry_renderer(device=device).frame_inputs()).color
