"""The renderer: scene in, frames out (port of trident_tpu/render/renderer.py).

The forward frame of a rigid, textured, lit scene, as the JAX package's
`_render_frame_impl(raster="pallas", forward_shading=True)` runs it:

    draw rows → corner stage (planar setup) → resolve records
    [→ light pass: draw rows → corner stage → build_bins → depth-only
       visibility kernel → shadow map]
    → build_bins → visibility kernel → untile
    → resolve kernel → texel kernel + shadow-taps kernel + PBR
      (RenderConfig.kernel may route this part: `ckern` takes the
       compact-bank visibility kernel, `fuse` the fused visibility +
       resolve kernel, `tiled_shade` the tiled resolve, the planar texel
       kernel and channel-planar shading, untiling only the RGBA frame)
    [→ bloom on linear HDR → tonemap] [→ supersample resolve]
    [→ AI upscale: warp the previous history (warp kernel) → upscaler
       net → depth-to-space to 2× (the frame above ran at half size)]
    → RGBA8

PyTorch runs eagerly, so there is no jit, bundling or idle-frame cache;
tensors stay on the renderer's device. Bands, the AI-frame blend,
skyboxes, sprites, custom shaders, non-bilinear sampling, vertex colors
and skinning are not part of the ported slice: configuring them raises
NotImplementedError, and so does a kernel knob the port does not run
(ops/kernel_knobs.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.ecs.components import (
    LightComponent,
    LightType,
    MeshComponent,
    SpriteComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.geometry.mesh import GeometryCache
from trident_tpu_torch.geometry.primitives import PrimitiveType, build_primitive
from trident_tpu_torch.io.image import checkerboard
from trident_tpu_torch.ops import post, raster
from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage
from trident_tpu_torch.ops.deferred import (
    _background,
    apply_ai_blend,
    deferred_shade_attrs,
    pack_rgba8,
)
from trident_tpu_torch.ops.deferred_tiled import shade_attrs_tiled
from trident_tpu_torch.ops.kernel_knobs import (
    TILED_MAX_PIX,
    TILED_MAX_TABLE,
    KernelKnobs,
)
from trident_tpu_torch.ops.planes import build_resolve_cols_planar
from trident_tpu_torch.ops.resolve import (
    fused_visibility_resolve,
    resolve_attrs,
    resolve_attrs_tiled,
)
from trident_tpu_torch.ops.shading import tonemap_reinhard_gamma
from trident_tpu_torch.ops.shadow import (
    light_camera,
    render_shadow_map,
    scene_bounds,
)
from trident_tpu_torch.render.camera import EditorCamera
from trident_tpu_torch.render.frame import (
    DrawPlanCache,
    build_draw_params,
    gather_mesh_draws,
)
from trident_tpu_torch.render.lights import gather_lights
from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.render.types import (
    CameraParams,
    FrameOutput,
    GBuffer,
    ShadowParams,
    from_numpy,
)

logger = get_logger("renderer_torch")


def frame_geometry(plan, tri_draw, params, shade_table, camera, textures,
                   corner_t, *, width: int, height: int, draw_stride: int = 0,
                   real_draws: int = 0):
    """Per-frame geometry: (corner stage output, resolve records). The
    records are row-major (T, RR_WIDTH), one 128-byte line per triangle
    (the JAX package's (RW, T) columns, transposed; ops/planes.py). The
    per-draw consts are the shade row + the texture sizes row, so the
    resolve kernel needs no per-pixel table lookups."""
    tex_row = textures.sizes[params.texture_slot.long()].float()
    draw_consts = torch.cat([shade_table, tex_row], dim=1)
    draw_rows = build_draw_rows(params, camera, width, height,
                                draw_consts=draw_consts)
    cs = corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid, width,
                      height, draw_stride=draw_stride, real_draws=real_draws)
    return cs, build_resolve_cols_planar(cs.cols)


def shadow_params(plan, params, tri_draw, corner_t, light_cam: CameraParams,
                  size: int, bias: float, *, draw_stride: int = 0,
                  real_draws: int = 0, knobs: KernelKnobs = KernelKnobs()):
    """The light pass → (ShadowParams, (2,) i32 light-pass aux), with
    light_vp = proj @ view in f32 (TF32 is pinned off). The scalars are
    filled on the device: a host-to-device copy would wait for the work
    already queued. Under knobs.ckern the light pass takes the
    compact-bank kernel."""
    depth_map, aux = render_shadow_map(
        plan, params, light_cam, size, corner_t=corner_t, tri_draw=tri_draw,
        draw_stride=draw_stride, real_draws=real_draws,
        ck_bank=knobs.ck_bank if knobs.ckern else 0)
    dev = depth_map.device
    shadow = ShadowParams(
        depth=depth_map, light_vp=light_cam.proj @ light_cam.view,
        enabled=torch.ones((), dtype=torch.bool, device=dev),
        bias=torch.full((), bias, dtype=torch.float32, device=dev))
    return shadow, aux


def _visibility_and_shade(setup, setup_cols, records, textures, camera,
                          lights, *, width: int, height: int, clear_color,
                          shadow: Optional[ShadowParams] = None,
                          shadow_pcf: bool = False, tonemap: bool = True,
                          knobs: KernelKnobs = KernelKnobs()):
    """Rasterize + shade a frame from prebuilt per-triangle inputs →
    (frame (H,W,4) f32, GBuffer), routed by the kernel knobs as
    trident_tpu/render/renderer.py:99-193 routes them: visibility by the
    fused kernel (fuse), the compact-bank kernel (ckern) or K1; then,
    when tiled_shade is on and the JAX package's gate admits the frame,
    the tiled resolve (or the fused attributes) and channel-planar
    shading in tile layout; else the (H, W) attribute image and
    deferred_shade_attrs."""
    ntx, nty = -(-width // raster.TILE), -(-height // raster.TILE)
    n_tiles = ntx * nty
    bins = raster.build_bins(setup, width, height, setup_cols=setup_cols,
                             ck_bank=knobs.ck_bank if knobs.ckern else 0)
    attrs_t = None
    if knobs.fuse:
        depth_t, tri_t, attrs_t = fused_visibility_resolve(bins, records,
                                                           ntx, n_tiles)
    elif knobs.ckern:
        depth_t, tri_t = raster.visibility_ck_tiles(bins, ntx, n_tiles,
                                                    knobs.ck_bank)
    else:
        depth_t, tri_t = raster.visibility_tiles(bins, ntx, n_tiles)
    gbuf = GBuffer(
        tri_id=raster.untile_frame(tri_t, ntx, nty)[:height, :width]
        .contiguous(),
        depth=raster.untile_frame(depth_t, ntx, nty)[:height, :width]
        .contiguous(),
        aux=bins.aux)
    # the JAX package's gate (renderer.py:140-144): bilinear sampling (the
    # only mode ported) and its TPU texel kernel's pixel and table limits
    use_tiled = (knobs.tiled_shade and width * height <= TILED_MAX_PIX
                 and textures.quads.shape[0] <= TILED_MAX_TABLE)
    if use_tiled:
        if attrs_t is None:
            attrs_t = resolve_attrs_tiled(tri_t, records, ntx)
        rgba_t = shade_attrs_tiled(tri_t, depth_t, attrs_t, textures, camera,
                                   lights, width, height, shadow=shadow,
                                   shadow_pcf=shadow_pcf, tonemap=tonemap)
        frame4 = raster.untile_channels(rgba_t, ntx, nty)[:height, :width]
        covered = (gbuf.tri_id >= 0)[..., None]
        bg = _background(width, height, clear_color, frame4.device)
        rgb = torch.where(covered, frame4[..., :3], bg)
        a_out = torch.where(covered, frame4[..., 3:4], clear_color[3])
        frame = torch.cat([rgb, a_out], dim=-1)
        if tonemap:
            frame = torch.clamp(apply_ai_blend(frame, None), 0.0, 1.0)
        return frame, gbuf
    if attrs_t is not None:
        attrs = raster.untile_channels(attrs_t, ntx, nty)[:height, :width] \
            .contiguous()
    else:
        attrs = resolve_attrs(gbuf.tri_id, records)
    frame = deferred_shade_attrs(gbuf, attrs, textures, camera, lights,
                                 width, height, clear_color=clear_color,
                                 shadow=shadow, shadow_pcf=shadow_pcf,
                                 tonemap=tonemap)
    return frame, gbuf


def render_frame(plan, tri_draw, params, shade_table, camera, lights,
                 textures, corner_t, *, width: int, height: int, clear_color,
                 draw_stride: int = 0, real_draws: int = 0,
                 light_camera: Optional[CameraParams] = None,
                 shadow_size: int = 0, shadow_bias: float = 2e-3,
                 shadow_pcf: bool = False, supersample: int = 1,
                 bloom: bool = False, bloom_threshold: float = 1.0,
                 bloom_strength: float = 0.6,
                 upscale_params: Optional[up.UpscalerNet] = None,
                 prev=None,
                 knobs: KernelKnobs = KernelKnobs()) -> FrameOutput:
    """One forward frame (the JAX `_render_frame_impl` forward branch):
    main-pass geometry at (W·ss, H·ss) → the light pass when
    `light_camera` and `shadow_size` are given → visibility, resolve and
    shading (linear HDR when blooming) → bloom + tonemap → supersample
    resolve → [2× AI upscale] → clamp. Depth and ids are each ss × ss
    block's top-left sample; shadow_aux is the light pass's aux (None
    without one).

    With `upscale_params` (an UpscalerNet) width and height are the half
    size the scene renders at, and the frame comes out at twice that:
    the previous (history, view·proj) `prev` is warped into this view at
    the half-res depth, the net rebuilds the full frame from rgb and that
    temporal input, alpha, depth and ids are repeated 2×2, and
    FrameOutput.history holds the net's blocks as uint8 for the next
    frame. `knobs` (RenderConfig.kernel, validated) routes the light pass
    and _visibility_and_shade."""
    ss = max(int(supersample), 1)
    rw, rh = width * ss, height * ss
    cs, records = frame_geometry(
        plan, tri_draw, params, shade_table, camera, textures, corner_t,
        width=rw, height=rh, draw_stride=draw_stride, real_draws=real_draws)
    shadow = shadow_aux = None
    if shadow_size and light_camera is not None:
        shadow, shadow_aux = shadow_params(
            plan, params, tri_draw, corner_t, light_camera, shadow_size,
            shadow_bias, draw_stride=draw_stride, real_draws=real_draws,
            knobs=knobs)
    frame, gbuf = _visibility_and_shade(
        cs.setup, cs.cols.setup, records, textures, camera, lights,
        width=rw, height=rh, clear_color=clear_color, shadow=shadow,
        shadow_pcf=shadow_pcf, tonemap=not bloom, knobs=knobs)
    if bloom:
        hdr = post.bloom(frame[..., :3], bloom_threshold, bloom_strength)
        frame = torch.cat([tonemap_reinhard_gamma(hdr), frame[..., 3:4]],
                          dim=-1)
    frame = post.resolve_supersample(frame, ss)
    depth_out, tri_out = gbuf.depth[::ss, ::ss], gbuf.tri_id[::ss, ::ss]
    history = None
    if upscale_params is not None:
        temporal = up.temporal_from_prev(upscale_params, prev, depth_out,
                                         camera, width * 2, height * 2)
        rgb, blocks = up.apply_upscaler_v2(upscale_params, frame[..., :3],
                                           temporal, depth=depth_out)
        history = up.blocks_to_u8(blocks)
        frame = torch.cat([rgb, _repeat2(frame[..., 3:4])], dim=-1)
        depth_out, tri_out = _repeat2(depth_out), _repeat2(tri_out)
    frame = torch.clamp(apply_ai_blend(frame, None), 0.0, 1.0)
    return FrameOutput(color=pack_rgba8(frame), depth=depth_out,
                       tri_id=tri_out, aux=gbuf.aux, shadow_aux=shadow_aux,
                       history=history)


def _repeat2(a):
    """Each pixel of (H, W, …) repeated 2×2 → (2H, 2W, …)."""
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _check_slice(rc: RenderConfig) -> None:
    unported = {
        "use_pallas=False (reference raster)": rc.use_pallas is False,
        "forward_shading=False": not rc.forward_shading,
        "bands": rc.bands > 1,
        f"sampling={rc.sampling!r}": rc.sampling != "bilinear",
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to trident_tpu_torch yet: {', '.join(bad)}")


class Renderer:
    """Host-side scene state + the forward frame on one device (the card
    unless `device` says otherwise).

    With `render.ai_upscale` the upscaler's weights load at construction
    (`config.ai.upscaler_path`, else the port's assets/upscaler_2x.npz),
    and a file that cannot be loaded raises. The JAX package logs and
    renders at native size instead; the port does not, so that a run
    meant to go through the net and the warp kernel cannot quietly skip
    them.

    `render.kernel` is validated once here (ops/kernel_knobs.py: an
    unknown knob raises KeyError, an inconsistent set ValueError, a knob
    the port does not run NotImplementedError) and its KernelKnobs ride
    every frame explicitly, so Renderers with different knobs render
    their own frames side by side."""

    def __init__(self, config: Optional[EngineConfig] = None,
                 device=None) -> None:
        self.config = config or EngineConfig()
        rc = self.config.render
        _check_slice(rc)
        self.knobs = KernelKnobs.from_config(rc.kernel)
        self.device = resolve_device(device)
        self._upscaler: Optional[up.UpscalerNet] = None
        # (history, view·proj) of the last upscaled frame, the next one's
        # warp input
        self.prev_state: Optional[tuple] = None
        self._upscale_params()
        self.geometry = GeometryCache()
        self.textures = TextureSlots(max_slots=rc.max_textures,
                                     edge=rc.texture_size)
        self.registry: Optional[Registry] = None
        self.editor_camera = EditorCamera()
        self._plan_cache = DrawPlanCache(self.device)
        self._primitive_mesh_indices: Dict[PrimitiveType, int] = {}
        # scene_bounds' per-mesh bbox corners, valid for one geometry version
        self._mesh_boxes: Dict[int, Optional[np.ndarray]] = {}
        self._mesh_boxes_version: Optional[int] = None

    def set_active_registry(self, registry: Registry) -> None:
        self.registry = registry

    def ensure_primitive(self, kind: PrimitiveType) -> int:
        if kind not in self._primitive_mesh_indices:
            self._primitive_mesh_indices[kind] = self.geometry.add_mesh(
                build_primitive(kind))
        return self._primitive_mesh_indices[kind]

    def acquire_texture(self, key: str, rgba: Optional[np.ndarray] = None) -> int:
        return self.textures.acquire(key, rgba)

    def _upscale_params(self) -> Optional[up.UpscalerNet]:
        """The upscaler net on the device when ai_upscale is set (loaded
        once; a load failure raises), else None."""
        if not self.config.render.ai_upscale:
            return None
        if self._upscaler is None:
            self._upscaler, _bc = up.load_upscaler(
                self.config.ai.upscaler_path, self.device)
        return self._upscaler

    def _upscale_kwargs(self) -> dict:
        """render_frame's size and upscale arguments: the half size, the
        net and the previous frame's state when upscaling (the target's
        width and height even), else the target size alone."""
        rc = self.config.render
        net = self._upscale_params()
        if net is None or rc.width % 2 or rc.height % 2:
            return {"width": rc.width, "height": rc.height}
        return {"width": rc.width // 2, "height": rc.height // 2,
                "upscale_params": net, "prev": self.prev_state}

    def _stride_kwargs(self) -> dict:
        """draw_stride/real_draws for the uniform-instancing broadcast path
        (ops/corner.py), gated to ≥64k-triangle plans as in the reference."""
        stride, nd = self._plan_cache.draw_stride, self._plan_cache.real_draws
        if not stride or stride * nd < 65536:
            return {"draw_stride": 0, "real_draws": 0}
        return {"draw_stride": stride, "real_draws": nd}

    def _shadow_kwargs(self, records, packed) -> dict:
        """light_camera/shadow_size of the directional shadow pass, when
        rc.shadows is on: the first enabled directional light that casts
        shadows, framed on the drawn scene's bounds."""
        rc = self.config.render
        if not rc.shadows:
            return {}
        for _e, (lc,) in self.registry.view(LightComponent):
            if (lc.enabled and lc.light_type == LightType.DIRECTIONAL
                    and lc.cast_shadows):
                if self._mesh_boxes_version != self.geometry.version:
                    self._mesh_boxes = {}
                    self._mesh_boxes_version = self.geometry.version
                center, radius = scene_bounds(records, packed,
                                              self._mesh_boxes)
                cam = light_camera(lc.direction, center, radius)
                return {"light_camera": from_numpy(cam, self.device),
                        "shadow_size": rc.shadow_map_size}
        return {}

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
            corner_t=self._plan_cache.corner_table(packed),
            **self._upscale_kwargs(), clear_color=tuple(rc.clear_color),
            shadow_pcf=rc.shadow_pcf, supersample=max(int(rc.supersample), 1),
            bloom=rc.bloom, bloom_threshold=rc.bloom_threshold,
            bloom_strength=rc.bloom_strength, knobs=self.knobs,
            **self._stride_kwargs(), **self._shadow_kwargs(records, packed))

    def render_viewport(self) -> FrameOutput:
        """Render the configured viewport with the editor camera; an
        upscaled frame's (history, view·proj) becomes the next frame's
        `prev`."""
        rc = self.config.render
        self.editor_camera.set_viewport_size(rc.width, rc.height)
        inputs = self.frame_inputs()
        out = render_frame(**inputs)
        if out.history is not None:
            cam = inputs["camera"]
            self.prev_state = (out.history, cam.proj @ cam.view)
        return out

    def read_frame(self, out: Optional[FrameOutput] = None) -> np.ndarray:
        """Render (unless given a FrameOutput) and read back (H,W,4) uint8,
        warning when the main or the light pass dropped geometry."""
        if out is None:
            out = self.render_viewport()
        frame = out.color.cpu().numpy()
        if self.config.render.raster_drop_checks:
            for name, aux in (("", out.aux), ("light pass ", out.shadow_aux)):
                aux = None if aux is None else aux.cpu().numpy()
                if aux is not None and (aux[0] or aux[1]):
                    logger.warning(
                        "%sraster capacity overflow: %d pairs truncated, %d "
                        "chunks dropped — geometry is missing", name,
                        int(aux[0]), int(aux[1]))
        return frame


def build_entry_renderer(width: int = 256, height: int = 256,
                         device=None) -> Renderer:
    """The scene of `__graft_entry__._build_example`: one textured cube,
    rotated (20°, 35°, 0°), seen from (0, 0, 3), default sun."""
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
    the forward frame → (256, 256, 4) uint8 color on `device` (the card
    unless given). Like entry(), it takes the camera's parameters without
    sizing it to the frame, so the projection keeps the camera's default
    1920×1080 aspect."""
    return render_frame(**build_entry_renderer(device=device).frame_inputs()).color
