"""The renderer: scene in, frames out (port of trident_tpu/render/renderer.py).

The frame as the JAX package's `_render_frame_impl` runs it, on three
routes. The default (use_pallas None or True, forward_shading True) is
the forward frame:

    geometry: rigid frames draw rows → corner stage (planar setup);
      frames with a skinned draw the indexed path: vertex stage (gather,
      linear-blend skinning from the bone palette, transforms) → one
      (T, 3, 16) corner gather → triangle setup
    → resolve records
      (with vertex colours: the colour planes too, a (T, 40) table)
    [→ light pass: the same geometry path at the light camera → build_bins
       → depth-only visibility kernel → shadow map]
    → build_bins → visibility kernel → untile
    → resolve kernel (its 40-wide instance with vertex colours)
    → texture sample (the texel kernel: bilinear, or twice for trilinear;
      nearest is one gather) + shadow-taps kernel + PBR or a custom
      shader, the skybox or the clear color behind
      (RenderConfig.kernel may route this part: `ckern` takes the
       compact-bank visibility kernel, `fuse` the fused visibility +
       resolve kernel, `tiled_shade` the tiled resolve, the planar texel
       kernel and channel-planar shading, untiling only the RGBA frame,
       for bilinear frames without a custom shader)
    [→ bloom on linear HDR → tonemap] [→ supersample resolve]
    [→ AI upscale: warp the previous history (warp kernel) → upscaler
       net → depth-to-space to 2× (the frame above ran at half size)]
    → RGBA8

The plane-gather routes replace records, resolve and the attribute image
with attribute planes (ops/planes.py, f16 or f32 tables by plane_f16) and
deferred_shade, which gathers the winner's plane rows per pixel:
use_pallas=False is the reference raster (ops/raster_ref.py, its light
pass too), forward_shading=False the binned visibility kernel, untiled.
Both geometry paths feed all three routes. The JAX package takes the
reference raster for use_pallas=None on the CPU; the port keeps the
kernel route there too (its plain versions), so that the CPU tests run
the card's route.

The interactive loop (Renderer.render_viewport, draw_frame) ships each
frame's host state in two blobs (render/bundle.py) and, on the card,
replays one captured CUDA graph per frame key (render/graphs.py), the
counterpart of the JAX package's one jit per static shape; on the CPU
the same bundled frame runs eagerly; `set_ai_frame` mixes an
interpolated AI frame into the display frame. Sprites are quads drawn
with the meshes, `set_skybox` sets the background's cube map (with an
optional mip chain, one level picked per viewport), `set_custom_shader`
a user shading module (render/shader_hook.py), and `acquire_texture`
takes a file mip chain. Bands are not part of the ported slice:
configuring them raises NotImplementedError, and so does a kernel knob the
port does not run (ops/kernel_knobs.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import math

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.core.log import get_logger
from trident_tpu_torch.core.timing import FrameTimingRing, Time
from trident_tpu_torch.ecs.components import (
    CameraComponent,
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
from trident_tpu_torch.ops.corner import (
    CornerStageOut,
    build_draw_rows,
    corner_stage,
    indexed_corner_stage,
)
from trident_tpu_torch.ops.deferred import (
    _background,
    apply_ai_blend,
    deferred_shade,
    deferred_shade_attrs,
    pack_rgba8,
)
from trident_tpu_torch.ops.deferred_tiled import shade_attrs_tiled
from trident_tpu_torch.ops.kernel_knobs import (
    TILED_MAX_PIX,
    TILED_MAX_TABLE,
    KernelKnobs,
)
from trident_tpu_torch.ops.planes import (
    build_planes_cols,
    build_resolve_cols_planar,
)
from trident_tpu_torch.ops.raster_ref import visibility_ref
from trident_tpu_torch.ops.shading import SAMPLING_MODES
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
from trident_tpu_torch.ops.vertex import vertex_stage
from trident_tpu_torch.render.bundle import (
    BundleShape,
    pack_frame,
    unpack_frame,
)
from trident_tpu_torch.render.camera import Camera, EditorCamera, RuntimeCamera
from trident_tpu_torch.render.frame import (
    DrawPlanCache,
    DrawBatch,
    bone_palette_host,
    build_draw_params_host,
    gather_draw_batch,
    gather_sprite_batch,
    geometry_to_device,
)
from trident_tpu_torch.render.graphs import FrameGraphs, frame_key
from trident_tpu_torch.render.lights import gather_lights_host
from trident_tpu_torch.render.shader_hook import ShaderHook
from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.render.types import (
    AiBlend,
    CameraParams,
    FrameOutput,
    GBuffer,
    GeometryBuffers,
    ShadowParams,
    SkyboxCube,
    from_numpy,
)

logger = get_logger("renderer_torch")


RASTER_MODES = ("pallas", "ref")


def _geometry(plan, tri_draw, params, camera, corner_t, draw_consts, *,
              width: int, height: int, draw_stride: int = 0,
              real_draws: int = 0, vertex_colors: bool = False,
              geometry: Optional[GeometryBuffers] = None,
              palette: Optional[torch.Tensor] = None,
              skinned: bool = False) -> CornerStageOut:
    """The frame's setup and planar corner columns: the corner stage when
    `corner_t` is given and the frame is not `skinned`, else the indexed
    path (trident_tpu/render/renderer.py:284-297): the vertex stage over
    `geometry` (skinning from `palette` when `skinned`), one (T, 3, 16)
    corner gather, the triangle setup. `draw_consts` (D, 12) or None ride
    the columns as the records' shading consts."""
    if corner_t is not None and not skinned:
        draw_rows = build_draw_rows(params, camera, width, height,
                                    draw_consts=draw_consts)
        return corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid,
                            width, height, draw_stride=draw_stride,
                            real_draws=real_draws,
                            vertex_colors=vertex_colors)
    verts = vertex_stage(geometry, plan, params, camera, palette,
                         skinned=skinned)
    return indexed_corner_stage(
        verts.packed, plan.tri_vtx, plan.tri_valid, width, height,
        consts=None if draw_consts is None else draw_consts[tri_draw.long()],
        vertex_colors=vertex_colors)


def frame_geometry(plan, tri_draw, params, shade_table, camera, textures,
                   corner_t, *, width: int, height: int, draw_stride: int = 0,
                   real_draws: int = 0, vertex_colors: bool = False,
                   geometry: Optional[GeometryBuffers] = None,
                   palette: Optional[torch.Tensor] = None,
                   skinned: bool = False):
    """Per-frame geometry of the forward route: (corner stage output,
    resolve records). The records are row-major (T, RR_WIDTH), one
    128-byte line per triangle (the JAX package's (RW, T) columns,
    transposed; ops/planes.py), or with `vertex_colors` (T,
    RR_WIDTH_VCOLOR), the colour planes added. The per-draw consts are the
    shade row + the texture sizes row, so the resolve kernel needs no
    per-pixel table lookups. `geometry`, `palette` and `skinned` select
    the indexed path as _geometry says."""
    tex_row = textures.sizes[params.texture_slot.long()].float()
    draw_consts = torch.cat([shade_table, tex_row], dim=1)
    cs = _geometry(plan, tri_draw, params, camera, corner_t, draw_consts,
                   width=width, height=height, draw_stride=draw_stride,
                   real_draws=real_draws, vertex_colors=vertex_colors,
                   geometry=geometry, palette=palette, skinned=skinned)
    return cs, build_resolve_cols_planar(cs.cols)


def plane_geometry(plan, tri_draw, params, shade_table, camera, corner_t, *,
                   width: int, height: int, plane_f16: bool = False,
                   draw_stride: int = 0, real_draws: int = 0,
                   vertex_colors: bool = False,
                   geometry: Optional[GeometryBuffers] = None,
                   palette: Optional[torch.Tensor] = None,
                   skinned: bool = False):
    """Per-frame geometry of the plane-gather routes: (corner stage
    output, AttributePlanes), f16 tables with `plane_f16`
    (trident_tpu/render/renderer.py:345-351); the geometry path as
    frame_geometry's."""
    cs = _geometry(plan, tri_draw, params, camera, corner_t, None,
                   width=width, height=height, draw_stride=draw_stride,
                   real_draws=real_draws, vertex_colors=vertex_colors,
                   geometry=geometry, palette=palette, skinned=skinned)
    return cs, build_planes_cols(cs.cols, cs.setup.bbox, tri_draw,
                                 shade_table, f16=plane_f16)


def shadow_params(plan, params, tri_draw, corner_t, light_cam: CameraParams,
                  size: int, bias, *, draw_stride: int = 0,
                  real_draws: int = 0, knobs: KernelKnobs = KernelKnobs(),
                  geometry: Optional[GeometryBuffers] = None,
                  palette: Optional[torch.Tensor] = None,
                  skinned: bool = False, raster_mode: str = "pallas"):
    """The light pass → (ShadowParams, (2,) i32 light-pass aux), with
    light_vp = proj @ view in f32 (TF32 is pinned off). `bias` is a float
    or a () f32 tensor on the device (the frame bundle's). The scalars are
    filled on the device: a host-to-device copy would wait for the work
    already queued. Under knobs.ckern the light pass takes the
    compact-bank kernel; geometry path and raster as render_shadow_map
    takes them."""
    depth_map, aux = render_shadow_map(
        plan, params, light_cam, size, corner_t=corner_t, tri_draw=tri_draw,
        draw_stride=draw_stride, real_draws=real_draws,
        ck_bank=knobs.ck_bank if knobs.ckern else 0, geometry=geometry,
        palette=palette, skinned=skinned, raster_mode=raster_mode)
    dev = depth_map.device
    shadow = ShadowParams(
        depth=depth_map, light_vp=light_cam.proj @ light_cam.view,
        enabled=torch.ones((), dtype=torch.bool, device=dev),
        bias=(bias if isinstance(bias, torch.Tensor) else
              torch.full((), bias, dtype=torch.float32, device=dev)))
    return shadow, aux


def _visibility_and_shade(setup, setup_cols, records, textures, camera,
                          lights, *, width: int, height: int, clear_color,
                          shadow: Optional[ShadowParams] = None,
                          shadow_pcf: bool = False, tonemap: bool = True,
                          knobs: KernelKnobs = KernelKnobs(),
                          skybox: Optional[SkyboxCube] = None,
                          sampling: str = "bilinear", shader_fn=None):
    """Rasterize + shade a frame from prebuilt per-triangle inputs →
    (frame (H,W,4) f32, GBuffer), routed by the kernel knobs as
    trident_tpu/render/renderer.py:99-193 routes them: visibility by the
    fused kernel (fuse), the compact-bank kernel (ckern) or K1; then,
    when tiled_shade is on and the JAX package's gate admits the frame
    (bilinear sampling, no custom shader, the size limits), the tiled
    resolve (or the fused attributes) and channel-planar shading in tile
    layout; else the (H, W) attribute image and deferred_shade_attrs. The
    records' width picks the resolve kernels' instance (vertex colours or
    not)."""
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
    # the JAX package's gate (renderer.py:140-144): bilinear sampling, no
    # custom shader, and its TPU texel kernel's pixel and table limits
    use_tiled = (knobs.tiled_shade and sampling == "bilinear"
                 and shader_fn is None and width * height <= TILED_MAX_PIX
                 and textures.quads.shape[0] <= TILED_MAX_TABLE)
    if use_tiled:
        if attrs_t is None:
            attrs_t = resolve_attrs_tiled(tri_t, records, ntx)
        rgba_t = shade_attrs_tiled(tri_t, depth_t, attrs_t, textures, camera,
                                   lights, width, height, shadow=shadow,
                                   shadow_pcf=shadow_pcf, tonemap=tonemap)
        frame4 = raster.untile_channels(rgba_t, ntx, nty)[:height, :width]
        covered = (gbuf.tri_id >= 0)[..., None]
        bg = _background(camera, skybox, width, height, clear_color,
                         frame4.device)
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
                                 tonemap=tonemap, skybox=skybox,
                                 sampling=sampling, shader_fn=shader_fn)
    return frame, gbuf


def plane_visibility(setup, setup_cols, width: int, height: int,
                     raster_mode: str,
                     knobs: KernelKnobs = KernelKnobs()) -> GBuffer:
    """The plane-gather routes' G-buffer: the reference raster (chunk 64,
    trident_tpu/render/renderer.py:200-202) or the binned visibility
    kernel, untiled (:195-199; the compact-bank kernel under ckern)."""
    if raster_mode == "ref":
        return visibility_ref(setup, width, height, chunk=64)
    return raster.visibility(setup, width, height, setup_cols=setup_cols,
                             ck_bank=knobs.ck_bank if knobs.ckern else 0)


def render_frame(plan, tri_draw, params, shade_table, camera, lights,
                 textures, corner_t, *, width: int, height: int, clear_color,
                 draw_stride: int = 0, real_draws: int = 0,
                 light_camera: Optional[CameraParams] = None,
                 shadow_size: int = 0, shadow_bias: float = 2e-3,
                 shadow_pcf: bool = False, supersample: int = 1,
                 bloom: bool = False, bloom_threshold: float = 1.0,
                 bloom_strength: float = 0.6,
                 upscale_params: Optional[up.UpscalerNet] = None,
                 prev=None, ai: Optional[AiBlend] = None,
                 knobs: KernelKnobs = KernelKnobs(),
                 skybox: Optional[SkyboxCube] = None,
                 vertex_colors: bool = False, sampling: str = "bilinear",
                 shader_fn=None, raster_mode: str = "pallas",
                 forward_shading: bool = True, plane_f16: bool = False,
                 skinned: bool = False,
                 geometry: Optional[GeometryBuffers] = None,
                 palette: Optional[torch.Tensor] = None) -> FrameOutput:
    """One frame (the JAX `_render_frame_impl`): main-pass geometry at
    (W·ss, H·ss) → the light pass when `light_camera` and `shadow_size`
    are given → visibility, resolve and shading (linear HDR when
    blooming) → bloom + tonemap → supersample resolve → [2× AI upscale] →
    clamp. Depth and ids are each ss × ss block's top-left sample;
    shadow_aux is the light pass's aux (None without one).

    Routes: raster_mode "pallas" with forward_shading is the forward
    frame (records, the resolve kernel); raster_mode "ref" (the reference
    raster) or forward_shading False (the visibility kernel, untiled) is
    the plane-gather frame, attribute planes (f16 with `plane_f16`) and
    deferred_shade. Geometry: the corner stage from `corner_t`, or with
    corner_t None or `skinned` the indexed path over `geometry` (the
    device GeometryBuffers) with the bone `palette` (P, 4, 4); the light
    pass takes the same geometry path and raster.

    With `upscale_params` (an UpscalerNet) width and height are the half
    size the scene renders at, and the frame comes out at twice that:
    the previous (history, view·proj) `prev` is warped into this view at
    the half-res depth, the net rebuilds the full frame from rgb and that
    temporal input, alpha, depth and ids are repeated 2×2, and
    FrameOutput.history holds the net's blocks as uint8 for the next
    frame, with the view·proj it was seen through (FrameOutput.view_proj).
    `ai` (an AiBlend) mixes the interpolated AI frame in once, at display
    resolution: after the supersample resolve and the upscale, before the
    clamp (trident_tpu/render/renderer.py:405); the shading keeps none.
    `knobs` (RenderConfig.kernel, validated) routes the light pass and
    _visibility_and_shade. `vertex_colors` multiplies the colour factor
    by the meshes' interpolated vertex colours (the (T, 40) records),
    `sampling` is the texture sampling mode (shading.SAMPLING_MODES),
    `skybox` the background's cube map and `shader_fn` a custom shader's
    `shade` in place of the built-in PBR."""
    if raster_mode not in RASTER_MODES:
        raise ValueError(f"unknown raster mode {raster_mode!r}; expected "
                         f"one of {RASTER_MODES}")
    ss = max(int(supersample), 1)
    rw, rh = width * ss, height * ss
    forward = raster_mode == "pallas" and forward_shading
    geo_kw = dict(width=rw, height=rh, draw_stride=draw_stride,
                  real_draws=real_draws, vertex_colors=vertex_colors,
                  geometry=geometry, palette=palette, skinned=skinned)
    if forward:
        cs, records = frame_geometry(plan, tri_draw, params, shade_table,
                                     camera, textures, corner_t, **geo_kw)
    else:
        cs, planes = plane_geometry(plan, tri_draw, params, shade_table,
                                    camera, corner_t, plane_f16=plane_f16,
                                    **geo_kw)
    shadow = shadow_aux = None
    if shadow_size and light_camera is not None:
        shadow, shadow_aux = shadow_params(
            plan, params, tri_draw, corner_t, light_camera, shadow_size,
            shadow_bias, draw_stride=draw_stride, real_draws=real_draws,
            knobs=knobs, geometry=geometry, palette=palette,
            skinned=skinned, raster_mode=raster_mode)
    shade_kw = dict(clear_color=clear_color, shadow=shadow,
                    shadow_pcf=shadow_pcf, tonemap=not bloom, skybox=skybox,
                    sampling=sampling, shader_fn=shader_fn)
    if forward:
        frame, gbuf = _visibility_and_shade(
            cs.setup, cs.cols.setup, records, textures, camera, lights,
            width=rw, height=rh, knobs=knobs, **shade_kw)
    else:
        gbuf = plane_visibility(cs.setup, cs.cols.setup, rw, rh,
                                raster_mode, knobs)
        frame = deferred_shade(gbuf, planes, textures, camera, lights, rw,
                               rh, **shade_kw)
    if bloom:
        hdr = post.bloom(frame[..., :3], bloom_threshold, bloom_strength)
        frame = torch.cat([tonemap_reinhard_gamma(hdr), frame[..., 3:4]],
                          dim=-1)
    frame = post.resolve_supersample(frame, ss)
    depth_out, tri_out = gbuf.depth[::ss, ::ss], gbuf.tri_id[::ss, ::ss]
    history = view_proj = None
    if upscale_params is not None:
        view_proj = camera.proj @ camera.view
        temporal = up.temporal_from_prev(upscale_params, prev, depth_out,
                                         camera, width * 2, height * 2)
        rgb, blocks = up.apply_upscaler_v2(upscale_params, frame[..., :3],
                                           temporal, depth=depth_out)
        history = up.blocks_to_u8(blocks)
        frame = torch.cat([rgb, _repeat2(frame[..., 3:4])], dim=-1)
        depth_out, tri_out = _repeat2(depth_out), _repeat2(tri_out)
    frame = torch.clamp(apply_ai_blend(frame, ai), 0.0, 1.0)
    return FrameOutput(color=pack_rgba8(frame), depth=depth_out,
                       tri_id=tri_out, aux=gbuf.aux, shadow_aux=shadow_aux,
                       history=history, view_proj=view_proj)


def _repeat2(a):
    """Each pixel of (H, W, …) repeated 2×2 → (2H, 2W, …)."""
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def render_frame_bundled(plan, tri_draw, f32, i32, textures, corner_t,
                         upscale_params: Optional[up.UpscalerNet] = None,
                         prev=None, ai_image: Optional[torch.Tensor] = None,
                         skybox: Optional[SkyboxCube] = None,
                         *, shape: BundleShape, width: int,
                         height: int, clear_color, draw_stride: int = 0,
                         real_draws: int = 0, shadow_size: int = 0,
                         shadow_pcf: bool = False, supersample: int = 1,
                         bloom: bool = False, bloom_threshold: float = 1.0,
                         bloom_strength: float = 0.6,
                         knobs: KernelKnobs = KernelKnobs(),
                         vertex_colors: bool = False,
                         sampling: str = "bilinear",
                         shader_fn=None, raster_mode: str = "pallas",
                         forward_shading: bool = True,
                         plane_f16: bool = False, skinned: bool = False,
                         geometry: Optional[GeometryBuffers] = None
                         ) -> FrameOutput:
    """render_frame with every per-frame host value arriving in the two
    blobs of render/bundle.py (f32, i32: device tensors of the layout of
    `shape`), the interactive path (trident_tpu/render/renderer.py:
    457-495). The light camera is used when shadow_size is set; the
    shadow bias rides the blob, and so does the AI blend, which mixes
    `ai_image` ((H, W, 3) at display size, or (1, 1, 3)) into the frame;
    without an ai_image there is no mix; the bone palette rides it too.
    `skybox`, `vertex_colors`, `sampling`, `shader_fn`, the route
    (`raster_mode`, `forward_shading`, `plane_f16`), `skinned` and
    `geometry` are render_frame's."""
    (params, palette, shade_table, camera, lights, light_cam, ai_blend,
     shadow_bias) = unpack_frame(f32, i32, shape)
    return render_frame(
        plan, tri_draw, params, shade_table, camera, lights, textures,
        corner_t, width=width, height=height, clear_color=clear_color,
        draw_stride=draw_stride, real_draws=real_draws,
        light_camera=light_cam if shadow_size else None,
        shadow_size=shadow_size, shadow_bias=shadow_bias,
        shadow_pcf=shadow_pcf, supersample=supersample, bloom=bloom,
        bloom_threshold=bloom_threshold, bloom_strength=bloom_strength,
        upscale_params=upscale_params, prev=prev,
        ai=None if ai_image is None else AiBlend(ai_image, ai_blend),
        knobs=knobs, skybox=skybox, vertex_colors=vertex_colors,
        sampling=sampling, shader_fn=shader_fn, raster_mode=raster_mode,
        forward_shading=forward_shading, plane_f16=plane_f16,
        skinned=skinned, geometry=geometry, palette=palette)


def _check_slice(rc: RenderConfig) -> None:
    if rc.sampling not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {rc.sampling!r}; expected "
                         f"one of {SAMPLING_MODES}")
    unported = {"bands": rc.bands > 1}
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to trident_tpu_torch yet: {', '.join(bad)}")


@dataclass
class ViewportContext:
    """One offscreen target (reference: Renderer.h:421-428). ID 1 = scene
    (editor camera), ID 2 = game (runtime camera) by convention; ID 0 is
    the configured target, sized by RenderConfig's width and height."""

    viewport_id: int
    width: int
    height: int
    camera: Optional[Camera] = None
    last_frame: Optional[FrameOutput] = None
    last_sig: Optional[tuple] = None     # idle-frame cache key
    prev_state: Optional[tuple] = None   # (history, view·proj) of the last
                                         # upscaled frame: the next one's
                                         # warp input


class _FrameState(NamedTuple):
    """A frame's host-side state (render_viewport packs it, frame_inputs
    uploads it)."""

    packed: object                   # the geometry's PackedGeometry
    draws: DrawBatch                 # one row per drawn entity
    plan: object                     # DrawPlan (device)
    tri_draw: torch.Tensor           # (T,) draw per triangle (device)
    params: object                   # DrawParams (numpy)
    palette: np.ndarray              # (P, 4, 4) bone palette
    shade: np.ndarray                # (D, 8) shade rows
    lights: object                   # LightParams (numpy)
    light_camera: Optional[CameraParams]   # numpy, when shadowed
    shadow_size: int                 # 0 without a shadow pass
    skinned: bool                    # a draw carries bone matrices


class FrameBundle(NamedTuple):
    """One viewport's frame, packed and ready to render
    (Renderer.frame_bundle)."""

    state: _FrameState
    f32: np.ndarray                  # the two blobs (render/bundle.py)
    i32: np.ndarray
    key: tuple                       # its graph key (graphs.frame_key)
    prev: Optional[tuple]            # (history, view·proj) warped in
    ai: torch.Tensor                 # the AI image mixed in (device)
    frame_fn: Callable               # (f32, i32, prev, ai) on the device
                                     # → FrameOutput, eagerly
    keep: tuple                      # the device-resident inputs it reads
    upscaled: bool
    sig: tuple                       # the idle-frame signature


class Renderer:
    """Host-side scene state + the forward frame on one device (the card
    unless `device` says otherwise), with the JAX Renderer's interactive
    loop: viewports, the idle-frame cache, draw_frame's pacing and
    timing, picking and the runtime camera.

    Each frame's host state ships as the two blobs of render/bundle.py.
    On the card every frame replays a CUDA graph captured once per frame
    key (render/graphs.py, `self.graphs`); a capture or replay that fails
    raises, and nothing falls back to eager launches. On the CPU the
    frame runs eagerly (render_frame_bundled).

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
    their own frames side by side.

    `set_ai_frame(image, blend)` sets the interpolated AI frame that the
    display frame is mixed with (ops/deferred.py::apply_ai_blend); with no
    image, or blend ≤ 0, frames mix in a (1, 1, 3) zero image at blend 0,
    which leaves them as they are (trident_tpu/render/renderer.py:
    784-787).

    `render.use_pallas=False` renders on the reference raster and
    `render.forward_shading=False` through attribute planes (f16 tables
    by `render.plane_f16`); a frame with a skinned draw (an
    AnimationComponent with bone_matrices) takes the indexed geometry path
    over the geometry's device buffers, its bone palette packed into the
    frame bundle. Route, plane mode and `skinned` are statics of the frame
    and the palette's bucket is part of the bundle's shape, so each keys
    its own graph, and a replay reads the new pose from the blob.

    Vertex colours are found once per geometry version (any packed colour
    not 1, as the JAX Renderer decides) and ride the frame's statics, so
    they enter the graph key. `set_skybox`'s chain lives on the device;
    the level a viewport picks (`_skybox_for`) is baked into its frame's
    graph, and its shape and the skybox's version are part of the key, so
    a new set_skybox or a resize that picks another level captures anew.
    The custom shader's version is part of the key and of the idle-frame
    signature."""

    SCENE_VIEWPORT = 1
    GAME_VIEWPORT = 2

    def __init__(self, config: Optional[EngineConfig] = None,
                 device=None) -> None:
        self.config = config or EngineConfig()
        rc = self.config.render
        _check_slice(rc)
        self.knobs = KernelKnobs.from_config(rc.kernel)
        self.device = resolve_device(device)
        self._upscaler: Optional[up.UpscalerNet] = None
        self._upscale_params()
        self.geometry = GeometryCache()
        self.textures = TextureSlots(max_slots=rc.max_textures,
                                     edge=rc.texture_size)
        self.registry: Optional[Registry] = None
        self.editor_camera = EditorCamera()
        self.runtime_camera = RuntimeCamera()
        self.runtime_camera_ready = False
        self.time = Time()
        self.timing = FrameTimingRing(self.config.capture.perf_dir)
        self.viewports: Dict[int, ViewportContext] = {}
        self.set_viewport(0, rc.width, rc.height)
        self.active_viewport = 0
        self.graphs = (FrameGraphs(self.device)
                       if self.device.type == "cuda" else None)
        self._inflight: List[torch.cuda.Event] = []
        self.max_inflight = 3
        self._plan_cache = DrawPlanCache(self.device)
        self._geometry_buffers: Optional[GeometryBuffers] = None
        self._geometry_buffers_version = -1
        self._primitive_mesh_indices: Dict[PrimitiveType, int] = {}
        # scene_bounds' per-mesh bbox corners, valid for one geometry version
        self._mesh_boxes: Dict[int, Optional[np.ndarray]] = {}
        self._mesh_boxes_version: Optional[int] = None
        self._last_draws: Optional[DrawBatch] = None
        self._last_tri_draw: Optional[torch.Tensor] = None
        self._ai_image: Optional[torch.Tensor] = None
        self._ai_zero = torch.zeros((1, 1, 3), dtype=torch.float32,
                                    device=self.device)
        self.ai_blend = 0.0
        self._ai_version = 0
        self.shader_hook = ShaderHook()
        self._skybox_chain: List[torch.Tensor] = []
        self._skybox_version = 0
        self._vertex_colors = False
        self._vertex_colors_version = -1
        self.stats_models = 0
        self.stats_triangles = 0

    # -- registry / cameras / viewports -----------------------------------------
    def set_active_registry(self, registry: Registry) -> None:
        self.registry = registry

    def set_viewport(self, viewport_id: int, width: int, height: int,
                     camera: Optional[Camera] = None) -> ViewportContext:
        """Create or resize a viewport (and give it a camera). Viewport 0
        is the configured target: resizing it sets RenderConfig's width
        and height, and a change there resizes it."""
        ctx = self.viewports.get(viewport_id)
        if ctx is None:
            ctx = ViewportContext(viewport_id, width, height, camera)
            self.viewports[viewport_id] = ctx
        else:
            ctx.width, ctx.height = width, height
            if camera is not None:
                ctx.camera = camera
        if viewport_id == 0:
            self.config.render.width, self.config.render.height = width, height
        return ctx

    def _viewport(self, viewport_id: int) -> ViewportContext:
        ctx = self.viewports[viewport_id]
        if viewport_id == 0:
            rc = self.config.render
            ctx.width, ctx.height = rc.width, rc.height
        return ctx

    def _camera_for(self, ctx: ViewportContext) -> Camera:
        if ctx.camera is not None:
            cam = ctx.camera
        elif (ctx.viewport_id == self.GAME_VIEWPORT
              and self.runtime_camera_ready):
            cam = self.runtime_camera
        else:
            cam = self.editor_camera
        cam.set_viewport_size(ctx.width, ctx.height)
        return cam

    @property
    def prev_state(self) -> Optional[tuple]:
        """Viewport 0's (history, view·proj) of its last upscaled frame."""
        return self.viewports[0].prev_state

    @prev_state.setter
    def prev_state(self, value: Optional[tuple]) -> None:
        self.viewports[0].prev_state = value

    def bind_runtime_camera(self, registry: Registry) -> bool:
        """Find the primary CameraComponent and drive the runtime camera
        from it (RefreshRuntimeCameraBinding, Renderer.cpp:4545-4574)."""
        primary = None
        fallback = None
        for entity, (cam,) in registry.view(CameraComponent):
            if fallback is None:
                fallback = (entity, cam)
            if cam.primary:
                primary = (entity, cam)  # last primary wins: user cameras
                                         # override the seeded default
        primary = primary or fallback
        if primary is None:
            self.runtime_camera_ready = False
            return False
        entity, cam = primary
        transform = registry.try_get(entity, TransformComponent)
        if transform is None:
            transform = TransformComponent()
        self.runtime_camera.bind(transform, cam)
        self.runtime_camera_ready = True
        return True

    # -- assets -----------------------------------------------------------------
    def ensure_primitive(self, kind: PrimitiveType) -> int:
        if kind not in self._primitive_mesh_indices:
            self._primitive_mesh_indices[kind] = self.geometry.add_mesh(
                build_primitive(kind))
        return self._primitive_mesh_indices[kind]

    def acquire_texture(self, key: str, rgba: Optional[np.ndarray] = None,
                        mips=None) -> int:
        """A texture slot for `key` (render/textures.py), with an optional
        file mip chain `mips`."""
        return self.textures.acquire(key, rgba, mips=mips)

    def set_skybox(self, faces: np.ndarray, mips=None) -> None:
        """The background's cube map: faces (6, E, E, 3) float in [0, 1]
        ordered +x, −x, +y, −y, +z, −z, and `mips` an optional list of
        coarser levels (edge halved each). The chain is copied to the
        device; each viewport renders the level whose texel density best
        matches its resolution (_skybox_for)."""
        self._skybox_chain = [
            torch.from_numpy(np.array(f, np.float32)).to(self.device)
            for f in [faces, *(mips or [])]]
        self._skybox_valid = torch.ones((), dtype=torch.bool,
                                        device=self.device)
        self._skybox_version += 1

    def _skybox_for(self, height: int,
                    fov_deg: float) -> Optional[SkyboxCube]:
        """The chain level whose face edge best matches a viewport of
        `height` rows at `fov_deg` (trident_tpu/render/renderer.py:
        619-653): a 90° face needs about (π/2)·h / (2·tan(fov/2)) texels
        to be minification-free, and the smallest level still at least
        that dense is taken (level 0 when none is). None without a
        skybox."""
        chain = self._skybox_chain
        if not chain:
            return None
        best = 0
        if len(chain) > 1:
            ideal = (math.pi / 2.0) * height / max(
                2.0 * math.tan(math.radians(fov_deg) / 2.0), 1e-6)
            for lvl, faces in enumerate(chain):
                if faces.shape[1] >= ideal:
                    best = lvl
        return SkyboxCube(faces=chain[best], valid=self._skybox_valid)

    def set_custom_shader(self, path: str) -> bool:
        """Install (or hot-swap) a user shading module
        (render/shader_hook.py contract); True on success. The next frame
        captures anew with it; a failed load keeps the current shading and
        returns False (shader_hook.last_error says why)."""
        return self.shader_hook.load(path)

    def clear_custom_shader(self) -> None:
        """Back to the built-in Cook-Torrance PBR."""
        self.shader_hook.clear()

    def _upscale_params(self) -> Optional[up.UpscalerNet]:
        """The upscaler net on the device when ai_upscale is set (loaded
        once; a load failure raises), else None."""
        if not self.config.render.ai_upscale:
            return None
        if self._upscaler is None:
            self._upscaler, _bc = up.load_upscaler(
                self.config.ai.upscaler_path, self.device)
        return self._upscaler

    def set_ai_frame(self, image: Optional[np.ndarray], blend: float) -> None:
        """The AI frame ((H, W, 3) f32 in [0, 1] at the display size, or
        None) and its blend (clipped to [0, 1] in the frame; ≤ 0 is
        none). Each call is a new AI frame: the idle-frame cache misses
        after it."""
        if image is not None:
            image = np.array(image, np.float32)      # a copy of the caller's
            if image.ndim != 3 or image.shape[-1] != 3:
                raise ValueError(f"an AI frame is (H, W, 3), not "
                                 f"{image.shape}")
            image = torch.from_numpy(image).to(self.device)
        self._ai_image = image
        self.ai_blend = float(blend)
        self._ai_version += 1

    def _ai_input(self):
        """(image, blend, version) the frame mixes in: the AI frame when
        one is set with blend > 0, else the (1, 1, 3) zero image at blend
        0 and version −1."""
        if self._ai_image is not None and self.ai_blend > 0.0:
            return self._ai_image, self.ai_blend, self._ai_version
        return self._ai_zero, 0.0, -1

    # -- frame ------------------------------------------------------------------
    def _upscale_kwargs(self, width: int, height: int, prev) -> dict:
        """render_frame's size and upscale arguments for a width × height
        target: the half size, the net and `prev` when upscaling (the
        target's width and height even), else the target size alone."""
        net = self._upscale_params()
        if net is None or width % 2 or height % 2:
            return {"width": width, "height": height}
        return {"width": width // 2, "height": height // 2,
                "upscale_params": net, "prev": prev}

    def _stride_kwargs(self, skinned: bool = False) -> dict:
        """draw_stride/real_draws for the uniform-instancing broadcast path
        (ops/corner.py), gated to ≥64k-triangle plans as in the reference;
        none for a skinned frame (it takes the indexed path)."""
        stride, nd = self._plan_cache.draw_stride, self._plan_cache.real_draws
        if skinned or not stride or stride * nd < 65536:
            return {"draw_stride": 0, "real_draws": 0}
        return {"draw_stride": stride, "real_draws": nd}

    def _shadow_host(self, draws: DrawBatch, packed):
        """(light camera as numpy, shadow map size) of the directional
        shadow pass when rc.shadows is on: the first enabled directional
        light that casts shadows, framed on the drawn scene's bounds;
        (None, 0) without one."""
        rc = self.config.render
        if not rc.shadows:
            return None, 0
        for _e, (lc,) in self.registry.view(LightComponent):
            if (lc.enabled and lc.light_type == LightType.DIRECTIONAL
                    and lc.cast_shadows):
                if self._mesh_boxes_version != self.geometry.version:
                    self._mesh_boxes = {}
                    self._mesh_boxes_version = self.geometry.version
                center, radius = scene_bounds(draws, packed,
                                              self._mesh_boxes)
                return (light_camera(lc.direction, center, radius),
                        rc.shadow_map_size)
        return None, 0

    def _frame_state(self) -> _FrameState:
        """The current scene's host state: draws (the meshes, then the
        sprites as quads), plan, per-draw rows, lights and the light
        camera; and whether the geometry has vertex colours (raises on
        what is not ported)."""
        if self.registry is None:
            raise RuntimeError("no active registry — call set_active_registry")
        sprites = any(True for _ in self.registry.view(SpriteComponent))
        quad = self.ensure_primitive(PrimitiveType.QUAD) if sprites else -1
        packed = self.geometry.packed()
        if self._vertex_colors_version != self.geometry.version:
            self._vertex_colors = bool((packed.colors != 1.0).any())
            self._vertex_colors_version = self.geometry.version
        draws = gather_draw_batch(self.registry, self.geometry)
        if sprites:
            draws = draws.concat(gather_sprite_batch(
                self.registry, quad, self.time.elapsed,
                texture_lookup=self.textures.lookup))
        plan, tri_draw = self._plan_cache.plan(packed, draws,
                                               self.geometry.version)
        rc = self.config.render
        params, shade = build_draw_params_host(
            draws, plan.num_draws,
            material_table=self.geometry.material_table(),
            max_bones=rc.max_bones)
        palette = bone_palette_host(draws, plan.num_draws, rc.max_bones)
        light_cam, shadow_size = self._shadow_host(draws, packed)
        return _FrameState(packed, draws, plan, tri_draw, params, palette,
                           shade, gather_lights_host(self.registry),
                           light_cam, shadow_size, draws.skinned)

    def _raster_mode(self) -> str:
        """"ref" (the reference raster) when use_pallas is False, else
        "pallas": the port's kernel route on either device."""
        return "ref" if self.config.render.use_pallas is False else "pallas"

    def _statics(self, shadow_size: int, skinned: bool = False) -> dict:
        """render_frame_bundled's static keyword arguments (the knobs and
        the size aside)."""
        rc = self.config.render
        return dict(clear_color=tuple(rc.clear_color),
                    shadow_size=shadow_size, shadow_pcf=rc.shadow_pcf,
                    supersample=max(int(rc.supersample), 1), bloom=rc.bloom,
                    bloom_threshold=rc.bloom_threshold,
                    bloom_strength=rc.bloom_strength,
                    vertex_colors=self._vertex_colors, sampling=rc.sampling,
                    raster_mode=self._raster_mode(),
                    forward_shading=rc.forward_shading,
                    plane_f16=rc.plane_f16, skinned=skinned,
                    **self._stride_kwargs(skinned))

    def _device_geometry(self, st: _FrameState):
        """(GeometryBuffers, corner table): the geometry's device buffers
        (uploaded once per geometry version) and no corner table for a
        skinned frame, which takes the indexed path; no buffers and the
        plan's corner table for a rigid one."""
        if not st.skinned:
            return None, self._plan_cache.corner_table(st.packed)
        if self._geometry_buffers_version != self.geometry.version:
            self._geometry_buffers = geometry_to_device(st.packed,
                                                        self.device)
            self._geometry_buffers_version = self.geometry.version
        return self._geometry_buffers, None

    def frame_inputs(self) -> dict:
        """render_frame's arguments for the current scene, on the device,
        with the editor camera as it stands at the configured size (the
        eager reference of viewport 0's frame; render_viewport first sizes
        the camera to the viewport), the AI frame mixed in when one is
        set."""
        rc = self.config.render
        st = self._frame_state()
        dev = self.device
        statics = self._statics(st.shadow_size, st.skinned)
        ai_image, ai_blend, _v = self._ai_input()
        if st.light_camera is None:
            del statics["shadow_size"]
        else:
            statics["light_camera"] = from_numpy(st.light_camera, dev)
        geometry, corner_t = self._device_geometry(st)
        return dict(
            plan=st.plan, tri_draw=st.tri_draw,
            params=from_numpy(st.params, dev),
            shade_table=torch.from_numpy(st.shade).to(dev),
            camera=self.editor_camera.params(dev),
            lights=from_numpy(st.lights, dev),
            textures=self.textures.device_arrays(dev),
            corner_t=corner_t, geometry=geometry,
            palette=torch.from_numpy(st.palette).to(dev),
            **self._upscale_kwargs(rc.width, rc.height, self.prev_state),
            ai=(AiBlend(ai_image, torch.full((), ai_blend,
                                             dtype=torch.float32, device=dev))
                if ai_blend > 0.0 else None),
            knobs=self.knobs,
            skybox=self._skybox_for(rc.height, self.editor_camera.fov_deg),
            shader_fn=self.shader_hook.fn, **statics)

    def frame_bundle(self, viewport_id: int = 0) -> FrameBundle:
        """The viewport's frame as render_viewport renders it: the scene's
        host state packed into the two blobs, the frame's graph key and
        the eager frame over device blobs (render_frame_bundled with
        everything else bound)."""
        ctx = self._viewport(viewport_id)
        cam = self._camera_for(ctx)
        st = self._frame_state()
        ai_image, ai_blend, ai_version = self._ai_input()
        f32, i32, shape = pack_frame(st.params, st.palette, st.shade,
                                     cam.host_params(), st.lights,
                                     st.light_camera, ai_blend)
        sizes = self._upscale_kwargs(ctx.width, ctx.height, ctx.prev_state)
        net, prev = sizes.get("upscale_params"), sizes.get("prev")
        w_r, h_r = sizes["width"], sizes["height"]
        statics = self._statics(st.shadow_size, st.skinned)
        versions = (self.geometry.version, self._plan_cache.version,
                    self.textures.version, net is not None)
        # the skybox level of this viewport (at its display height) is
        # baked into the graph: its shape and the chain's version key it
        skybox = self._skybox_for(ctx.height, cam.fov_deg)
        sky = (None if skybox is None
               else (tuple(skybox.faces.shape), self._skybox_version))
        shader_fn, shader_version = self.shader_hook.fn, self.shader_hook.version
        key = frame_key(shape, w_r, h_r, statics, self.knobs,
                        prev is not None, versions, ai_image.shape, sky,
                        shader_version)
        # every input of the frame but `prev`, as the JAX signature (the AI
        # frame by its version: a new one misses the cache)
        sig = (f32.tobytes(), i32.tobytes(), shape, w_r, h_r, versions,
               tuple(sorted(statics.items())), self.knobs, ai_version, sky,
               shader_version)
        textures = self.textures.device_arrays(self.device)
        geometry, corner_t = self._device_geometry(st)
        plan, tri_draw = st.plan, st.tri_draw
        kw = dict(shape=shape, width=w_r, height=h_r, knobs=self.knobs,
                  skybox=skybox, shader_fn=shader_fn, geometry=geometry,
                  **statics)
        return FrameBundle(
            st, f32, i32, key, prev, ai_image,
            lambda f, i, p, a: render_frame_bundled(
                plan, tri_draw, f, i, textures, corner_t, net, p, a, **kw),
            (plan, tri_draw, textures, corner_t, net, skybox, shader_fn,
             geometry),
            net is not None, sig)

    def render_viewport(self, viewport_id: int = 0) -> FrameOutput:
        """Render one viewport (trident_tpu/render/renderer.py:749-971):
        pack the frame (frame_bundle); when every input is byte-identical
        to the viewport's last frame, return that frame (the idle-frame
        cache); else replay the frame's graph on the card (eager
        render_frame_bundled on the CPU). An upscaled frame's (history,
        view·proj) becomes the viewport's next `prev`. The idle-frame
        signature is kept only once the frame is rendered, so a frame
        that raises is rendered anew on the next call."""
        ctx = self._viewport(viewport_id)
        fb = self.frame_bundle(viewport_id)
        st = fb.state
        self.stats_models = len(st.draws)
        self.stats_triangles = sum(
            st.packed.draw_infos[m].index_count // 3
            for m in st.draws.mesh_index.tolist())
        self._last_draws = st.draws
        self._last_tri_draw = st.tri_draw
        # idle-frame cache: if EVERY input is byte-identical to the
        # previous frame of this viewport, skip the frame and reuse its
        # output (what an editor does while nothing moves)
        if ctx.last_frame is not None and ctx.last_sig == fb.sig:
            return ctx.last_frame
        if self.graphs is None:
            out = fb.frame_fn(torch.from_numpy(fb.f32),
                              torch.from_numpy(fb.i32), fb.prev, fb.ai)
        else:
            out = self.graphs.run(fb.key, fb.f32, fb.i32, fb.prev, fb.ai,
                                  fb.frame_fn, keep=fb.keep)
        if fb.upscaled:
            ctx.prev_state = (out.history, out.view_proj)
        ctx.last_frame, ctx.last_sig = out, fb.sig
        return out

    def draw_frame(self) -> FrameOutput:
        """Render all viewports (active last), with frames-in-flight pacing
        and frame timing accumulation — the DrawFrame analogue. On the
        card at most max_inflight frames are outstanding: each frame
        records an event, and the oldest is waited for past that (the JAX
        Renderer's block_until_ready)."""
        dt = self.time.tick()
        for vid in sorted(self.viewports):
            if vid != self.active_viewport:
                self.render_viewport(vid)
        out = self.render_viewport(self.active_viewport)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self._inflight.append(done)
            if len(self._inflight) > self.max_inflight:
                self._inflight.pop(0).synchronize()
        ctx = self.viewports[self.active_viewport]
        self.timing.accumulate(dt * 1000.0, (ctx.width, ctx.height))
        return out

    def read_frame(self, out: Optional[FrameOutput] = None,
                   viewport_id: Optional[int] = None) -> np.ndarray:
        """Render (unless given a FrameOutput) and read back (H,W,4) uint8,
        warning when the main or the light pass dropped geometry."""
        if out is None:
            vid = self.active_viewport if viewport_id is None else viewport_id
            out = self.render_viewport(vid)
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

    # -- picking ------------------------------------------------------------------
    def _tri_map_entity(self, tri_map: np.ndarray, x: int, y: int,
                        ctx: ViewportContext) -> Optional[int]:
        """Shared picking core: winner-triangle map + draw plan → entity,
        with the rescale and bounds guards: ids from a stale frame can
        exceed the CURRENT tri_draw after the plan shrinks, and tri_id may
        be at another resolution than the viewport (supersampling)."""
        if self._last_tri_draw is None or not self._last_draws:
            return None
        ty = int(np.clip(y * tri_map.shape[0] // max(ctx.height, 1),
                         0, tri_map.shape[0] - 1))
        tx = int(np.clip(x * tri_map.shape[1] // max(ctx.width, 1),
                         0, tri_map.shape[1] - 1))
        tri = int(tri_map[ty, tx])
        if tri < 0 or tri >= int(self._last_tri_draw.shape[0]):
            return None
        draw = int(self._last_tri_draw[tri])
        if draw < 0 or draw >= len(self._last_draws):
            return None
        return int(self._last_draws.entity[draw])

    def pick_entity(self, x: int, y: int,
                    viewport_id: Optional[int] = None) -> Optional[int]:
        """Entity under the pixel (viewport coordinates) or None: the
        frame's winner-triangle id maps through the draw plan back to the
        ECS entity that issued the draw (renders the viewport first)."""
        vid = self.active_viewport if viewport_id is None else viewport_id
        out = self.render_viewport(vid)
        return self._tri_map_entity(out.tri_id.cpu().numpy(), x, y,
                                    self.viewports[vid])

    def pick(self, x: int, y: int, viewport_id: Optional[int] = None) -> int:
        """Entity under pixel (x,y) of the LAST rendered frame (no
        re-render), or -1 — the viewport click-select. Uses the
        winner-triangle GBuffer, so it is exact per pixel."""
        vid = self.active_viewport if viewport_id is None else viewport_id
        ctx = self.viewports.get(vid)
        if ctx is None or ctx.last_frame is None:
            return -1
        if not (0 <= y < ctx.height and 0 <= x < ctx.width):
            return -1
        ent = self._tri_map_entity(ctx.last_frame.tri_id.cpu().numpy(),
                                   x, y, ctx)
        return -1 if ent is None else ent


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
