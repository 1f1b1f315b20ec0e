"""The banded multi-device frame: sort-middle over a list of devices.

Port of trident_tpu/parallel/framebuffer.py. The JAX package runs one
program over a 1-D device mesh (`shard_map` over its "fb" axis, the bands
joined by `all_gather`); here one process drives a list of devices, one
band each, and each band's work is queued on its own device's current
stream. A device may appear more than once: n bands on one card run the
same code, offset branches included, as the JAX tests run n bands on
virtual CPU devices. The frame runs in three phases:

  1. geometry, split over the devices: device b transforms its slice of
     the vertices (the indexed or skinned path; the corner path has
     none) and sets up its slice of the triangles (edge functions, the
     resolve records or attribute planes) in full-frame pixel
     coordinates. The work arrays are padded to a multiple of n as
     `_pad_to` pads them (pad triangles are invalid, at the end). The
     slices are then concatenated and copied once to each distinct
     device (the JAX all_gather, tiled), so n bands on one card hold one
     full setup.
  2. band cut: each band restricts the full setup to its rows
     (ops/vertex.py::band_slice_setup, cull=False): bboxes band-local and
     clipped, so the binner emits no pair for a sub-block with no rows in
     the band, and the band's pairs are the full frame's pairs on its
     rows. The JAX function also invalidates the triangles that miss the
     band; the port keeps them valid, because a culled sub-block that
     straddles the band can lose a winner the full frame keeps (a
     rounding hit just outside a triangle's own bbox; band_slice_setup
     says how), and the port's bands must be the full frame bit for bit.
  3. band raster and shade: the frame's kernels run per band at
     y_offset = b·band_h with the frame's full height, through their band
     instances (the `*_band` entry points), which evaluate every pixel at its
     global centre; the bands' rows are the one-device frame's, bit for
     bit, and they concatenate on devices[0].

The light pass is banded over the same devices when the map's rows split
into whole tiles per band; otherwise each distinct device renders the
whole map. Bloom, the supersample resolve, the V1 upscale
(ai/upscaler.py::apply_upscaler, as the JAX banded frame takes) and the AI
blend run on the joined frame on devices[0]. FrameOutput.aux is the
bands' aux joined, (2n,) i32, and shadow_aux the light pass's (the bands'
joined when it is banded); history stays None, and with the upscaler
view_proj holds the camera's proj @ view for the next frame's warp of
the RGBA8 frame.

The banded frame runs eagerly: it never enters the Renderer's CUDA
graphs (render/graphs.py).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.ops import post, raster
from trident_tpu_torch.ops.corner import (
    CornerStageOut,
    build_draw_rows,
    corner_stage,
    indexed_corner_stage,
)
from trident_tpu_torch.ops.deferred import (
    apply_ai_blend,
    deferred_shade,
    pack_rgba8,
)
from trident_tpu_torch.ops.kernel_knobs import KernelKnobs
from trident_tpu_torch.ops.planes import (
    build_planes_cols,
    build_resolve_cols_planar,
)
from trident_tpu_torch.ops.raster_ref import visibility_ref
from trident_tpu_torch.ops.shading import tonemap_reinhard_gamma
from trident_tpu_torch.ops.vertex import (
    SetupCols,
    TriangleSetup,
    band_slice_setup,
    vertex_stage,
)
from trident_tpu_torch.render.bundle import BundleShape, unpack_frame
from trident_tpu_torch.render.renderer import (
    RASTER_MODES,
    _repeat2,
    _visibility_and_shade,
    plane_visibility,
)
from trident_tpu_torch.render.types import (
    AiBlend,
    CameraParams,
    FrameOutput,
    ShadowParams,
)

Tensor = torch.Tensor


def _pad_to(x: Tensor, m: int, value=0) -> Tensor:
    """x padded along dim 0 to a multiple of m with `value`."""
    pad = -x.shape[0] % m
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def _to(obj, device):
    """`obj` (a tensor, a NamedTuple or tuple of them, or anything else)
    with every tensor on `device`."""
    if isinstance(obj, Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        parts = [_to(v, device) for v in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else tuple(parts)
    return obj


def _distinct(devices) -> List[torch.device]:
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def _join(parts, device, dim: int = 0):
    """The slices `parts` (tensors, or NamedTuples / tuples of them, None
    fields kept) concatenated on `device`: the JAX all_gather, tiled."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, Tensor):
        return torch.cat([p.to(device) for p in parts], dim=dim)
    joined = [_join([p[k] for p in parts], device, dim)
              for k in range(len(first))]
    return (type(first)(*joined) if hasattr(first, "_fields")
            else tuple(joined))


def _sharded_geometry(shards: List[dict], camera: str, *, width: int,
                      height: int, use_corner: bool, skinned: bool,
                      consts: bool, vertex_colors: bool) -> list:
    """Each band device's CornerStageOut for its slice of the triangles,
    at the camera named `camera` and a width × height target, in
    full-frame pixel coordinates (trident_tpu/parallel/framebuffer.py:
    58-77). `shards` holds each band's inputs on its device (the plan,
    tri_draw, params, palette, geometry, corner_t and draw_consts of
    render_frame_banded's per-device copies, and "device"). The corner
    stage runs on the device's slice of the corner table (gathering the
    draw rows: the uniform-instancing broadcast gives the same rows); the
    indexed path runs each device's vertex slice through the vertex stage,
    joins the packed rows on each distinct device, then runs the device's
    triangle slice through indexed_corner_stage. `consts` adds the
    records' per-draw shading consts."""
    n = len(shards)
    tn = shards[0]["plan"].tri_valid.shape[0] // n
    tri_sl = [slice(b * tn, (b + 1) * tn) for b in range(n)]
    if use_corner:
        out = []
        for sl, sh in zip(tri_sl, shards):
            rows = build_draw_rows(sh["params"], sh[camera], width, height,
                                   draw_consts=sh["draw_consts"] if consts
                                   else None)
            out.append(corner_stage(
                sh["corner_t"][:, sl], rows, sh["tri_draw"][sl],
                sh["plan"].tri_valid[sl], width, height,
                vertex_colors=vertex_colors))
        return out
    vn = shards[0]["plan"].vtx_src.shape[0] // n
    packed = []
    for b, sh in enumerate(shards):
        vs = slice(b * vn, (b + 1) * vn)
        plan_v = sh["plan"]._replace(vtx_src=sh["plan"].vtx_src[vs],
                                     vtx_draw=sh["plan"].vtx_draw[vs])
        packed.append(vertex_stage(sh["geometry"], plan_v, sh["params"],
                                   sh[camera], sh["palette"],
                                   skinned=skinned).packed)
    packed_on = {d: _join(packed, d)
                 for d in _distinct([sh["device"] for sh in shards])}
    return [indexed_corner_stage(
        packed_on[sh["device"]], sh["plan"].tri_vtx[sl],
        sh["plan"].tri_valid[sl], width, height,
        consts=(sh["draw_consts"][sh["tri_draw"][sl].long()] if consts
                else None),
        vertex_colors=vertex_colors) for sl, sh in zip(tri_sl, shards)]


def _joined_setup(parts: List[CornerStageOut], device):
    """(TriangleSetup, SetupCols) of the slices joined on `device`."""
    setup = _join([p.setup for p in parts], device)
    cols = SetupCols(*(_join([p.cols.setup[k] for p in parts], device)
                       for k in range(len(SetupCols._fields))))
    return setup, cols


def _light_depth(setup: TriangleSetup, cols: SetupCols, size: int,
                 rows: int, y0: int, raster_mode: str,
                 knobs: KernelKnobs, band: bool):
    """(depth (rows, size) f32, (2,) i32 aux) of the light pass over map
    rows [y0, y0 + rows), its setup already cut to them when `band`: the
    depth-only kernel (its band instance for a band), or under ckern the
    compact-bank kernel with its ids dropped, or the reference raster."""
    if raster_mode == "ref":
        g = visibility_ref(setup, size, rows, y_offset=y0)
        return g.depth, g.aux
    ck = knobs.ck_bank if knobs.ckern else 0
    bins = raster.build_bins(setup, size, rows, setup_cols=cols, ck_bank=ck,
                             pair_budget=knobs.ck_pair_budget)
    ntx, nty = -(-size // raster.TILE), -(-rows // raster.TILE)
    tile_y = y0 // raster.TILE if band else None
    if ck:
        depth_t, _tri = raster.visibility_ck_tiles(bins, ntx, ntx * nty, ck,
                                                   tile_y)
    else:
        depth_t = raster.visibility_depth_tiles(bins, ntx, ntx * nty, tile_y)
    return raster.untile_frame(depth_t, ntx, nty)[:rows, :size], bins.aux


def render_frame_banded(devices, geometry, plan, tri_draw, params, palette,
                        shade_table, camera: CameraParams, lights, textures,
                        skybox, ai: Optional[AiBlend],
                        light_camera: Optional[CameraParams] = None,
                        corner_t: Optional[Tensor] = None, *, width: int,
                        height: int, clear_color,
                        raster_mode: str = "pallas", skinned: bool = False,
                        sampling: str = "bilinear",
                        vertex_colors: bool = False, plane_f16: bool = False,
                        forward_shading: bool = True, shadow_size: int = 0,
                        shadow_bias=2e-3, shadow_pcf: bool = False,
                        supersample: int = 1, bloom: bool = False,
                        bloom_threshold: float = 1.0,
                        bloom_strength: float = 0.6,
                        upscale_params: Optional[up.UpscalerNet] = None,
                        prev=None, shader_fn=None,
                        knobs: KernelKnobs = KernelKnobs()) -> FrameOutput:
    """Render (height, width) split into len(devices) row bands, band b on
    devices[b], with the geometry split over the same devices: the
    one-device render_frame's feature set (shadows, SSAA, bloom, f16 or
    f32 planes, the reference raster, the kernel knobs, vertex colours,
    skybox, custom shaders), its rows bit-equal to that frame's.

    The inputs are render_frame's, on any device (each band copies what
    it reads); `geometry` and `palette` feed the indexed path (corner_t
    None or `skinned`; a rigid frame whose triangle count does not split
    into n slices takes it too, as the JAX function does). With
    `upscale_params`
    width and height are the half size the bands render at and the frame
    comes out at twice that through the V1 upscaler (apply_upscaler),
    `prev` being (previous RGBA8 frame, its view·proj) or None
    (trident_tpu/parallel/framebuffer.py:80-308). Raises ValueError where
    the JAX function does: the render height (× supersample) must split
    into n bands, each a whole number of 32-row raster tiles (the kernel
    route) and of supersample rows."""
    if raster_mode not in RASTER_MODES:
        raise ValueError(f"unknown raster mode {raster_mode!r}; expected "
                         f"one of {RASTER_MODES}")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    ss = max(int(supersample), 1)
    rw, rh = width * ss, height * ss
    if rh % n:
        raise ValueError(f"render height {rh} not divisible by {n} bands")
    band_h = rh // n
    if raster_mode == "pallas" and band_h % raster.TILE:
        raise ValueError(f"band height {band_h} not a multiple of raster "
                         f"tile height {raster.TILE}")
    if band_h % ss:
        raise ValueError(f"band height {band_h} not a multiple of "
                         f"supersample {ss}")
    forward = raster_mode == "pallas" and forward_shading
    dev0 = devices[0]

    # the work arrays padded to multiples of n (pad vertices read row 0 of
    # draw 0, pad triangles are invalid)
    plan_p = plan._replace(vtx_src=_pad_to(plan.vtx_src, n),
                           vtx_draw=_pad_to(plan.vtx_draw, n),
                           tri_vtx=_pad_to(plan.tri_vtx, n),
                           tri_valid=_pad_to(plan.tri_valid, n, False))
    tri_draw_p = _pad_to(tri_draw, n)
    use_corner = (corner_t is not None and not skinned
                  and corner_t.shape[1] % n == 0)

    # each distinct device's copy of what its bands read
    frame_in = dict(plan=plan_p, tri_draw=tri_draw_p, params=params,
                    palette=palette, shade_table=shade_table,
                    geometry=geometry,
                    corner_t=corner_t if use_corner else None,
                    camera=camera, lights=lights, textures=textures,
                    skybox=skybox, light_camera=light_camera)
    on = {d: {k: _to(v, d) for k, v in frame_in.items()}
          for d in _distinct(devices)}
    for d, inp in on.items():
        inp["device"], inp["draw_consts"] = d, None
        if forward:
            tex_row = inp["textures"].sizes[
                inp["params"].texture_slot.long()].float()
            inp["draw_consts"] = torch.cat([inp["shade_table"], tex_row],
                                           dim=1)
    shards = [on[d] for d in devices]
    tn = tri_draw_p.shape[0] // n
    geo_kw = dict(use_corner=use_corner, skinned=skinned,
                  vertex_colors=vertex_colors)

    # -- phase 1: geometry over the devices, joined on each ---------------
    parts = _sharded_geometry(shards, "camera", width=rw, height=rh,
                              consts=forward, **geo_kw)
    if forward:
        tables = [build_resolve_cols_planar(p.cols) for p in parts]
    else:
        tables = [build_planes_cols(p.cols, p.setup.bbox,
                                    sh["tri_draw"][b * tn:(b + 1) * tn],
                                    sh["shade_table"], f16=plane_f16)
                  for b, (p, sh) in enumerate(zip(parts, shards))]
    joined = {d: (*_joined_setup(parts, d), _join(tables, d)) for d in on}

    # -- the light pass, banded over the devices when its rows split ------
    shadow_on = {d: None for d in on}
    shadow_aux = None
    if shadow_size and light_camera is not None:
        s = shadow_size
        sband_h = s // n
        banded = s % n == 0 and (raster_mode != "pallas"
                                 or sband_h % raster.TILE == 0)
        lparts = _sharded_geometry(
            shards, "light_camera", width=s, height=s, consts=False,
            **{**geo_kw, "vertex_colors": False})
        lsetup = {d: _joined_setup(lparts, d) for d in on}
        if banded:
            bands = [_light_depth(
                band_slice_setup(lsetup[d][0], b * sband_h, sband_h,
                                 cull=False),
                lsetup[d][1], s, sband_h, b * sband_h, raster_mode, knobs,
                True) for b, d in enumerate(devices)]
            depth_map = {d: _join([m for m, _a in bands], d) for d in on}
            shadow_aux = _join([a for _m, a in bands], dev0)
        else:
            whole = {d: _light_depth(*lsetup[d], s, s, 0, raster_mode,
                                     knobs, False) for d in on}
            depth_map = {d: m for d, (m, _a) in whole.items()}
            shadow_aux = whole[dev0][1].to(dev0)
        for d in on:
            lcam = on[d]["light_camera"]
            shadow_on[d] = ShadowParams(
                depth=depth_map[d], light_vp=lcam.proj @ lcam.view,
                enabled=torch.ones((), dtype=torch.bool, device=d),
                bias=(shadow_bias.to(d) if isinstance(shadow_bias, Tensor)
                      else torch.full((), shadow_bias, dtype=torch.float32,
                                      device=d)))

    # -- phases 2 + 3: band cut, raster and shade at global pixels --------
    frames, depths, ids, auxes = [], [], [], []
    for b, d in enumerate(devices):
        setup, cols, table = joined[d]
        inp = on[d]
        y0 = b * band_h
        s_band = band_slice_setup(setup, y0, band_h, cull=False)
        shade_kw = dict(clear_color=clear_color, shadow=shadow_on[d],
                        shadow_pcf=shadow_pcf, tonemap=not bloom,
                        skybox=inp["skybox"], sampling=sampling,
                        shader_fn=shader_fn, y_offset=y0, full_height=rh)
        if forward:
            frame, gbuf = _visibility_and_shade(
                s_band, cols, table, inp["textures"], inp["camera"],
                inp["lights"], width=rw, height=band_h, knobs=knobs,
                **shade_kw)
        else:
            gbuf = plane_visibility(s_band, cols, rw, band_h, raster_mode,
                                    knobs, y_offset=y0)
            frame = deferred_shade(gbuf, table, inp["textures"],
                                   inp["camera"], inp["lights"], rw, band_h,
                                   **shade_kw)
        frames.append(frame)
        depths.append(gbuf.depth)
        ids.append(gbuf.tri_id)
        auxes.append(gbuf.aux)
    frame = _join(frames, dev0)
    depth, tri_id, aux = (_join(x, dev0) for x in (depths, ids, auxes))

    # -- screen-space post on the joined frame ----------------------------
    cam0 = on[dev0]["camera"]
    if bloom:
        hdr = post.bloom(frame[..., :3], bloom_threshold, bloom_strength)
        frame = torch.cat([tonemap_reinhard_gamma(hdr), frame[..., 3:4]],
                          dim=-1)
    frame = post.resolve_supersample(frame, ss)
    depth_out, tri_out = depth[::ss, ::ss], tri_id[::ss, ::ss]
    view_proj = net_color = None
    if upscale_params is not None:
        view_proj = cam0.proj @ cam0.view
        temporal = up.temporal_from_prev(upscale_params, prev, depth_out,
                                         cam0, width * 2, height * 2)
        net_color = frame[..., :3]
        rgb = up.apply_upscaler(upscale_params, net_color, temporal,
                                depth=depth_out)
        frame = torch.cat([rgb, _repeat2(frame[..., 3:4])], dim=-1)
        depth_out, tri_out = _repeat2(depth_out), _repeat2(tri_out)
    frame = torch.clamp(apply_ai_blend(frame, _to(ai, dev0)), 0.0, 1.0)
    return FrameOutput(color=pack_rgba8(frame), depth=depth_out,
                       tri_id=tri_out, aux=aux, shadow_aux=shadow_aux,
                       history=None, view_proj=view_proj,
                       net_color=net_color)


def render_frame_banded_bundled(devices, geometry, plan, tri_draw, f32, i32,
                                textures, skybox, ai_image, corner_t=None,
                                upscale_params=None, prev=None, *,
                                shape: BundleShape, width: int, height: int,
                                clear_color, raster_mode: str = "pallas",
                                skinned: bool = False,
                                sampling: str = "bilinear",
                                vertex_colors: bool = False,
                                plane_f16: bool = False,
                                forward_shading: bool = True,
                                shadow_size: int = 0,
                                shadow_pcf: bool = False,
                                supersample: int = 1, bloom: bool = False,
                                bloom_threshold: float = 1.0,
                                bloom_strength: float = 0.6, shader_fn=None,
                                knobs: KernelKnobs = KernelKnobs()
                                ) -> FrameOutput:
    """render_frame_banded with every per-frame host value arriving in the
    two blobs of render/bundle.py (f32, i32: device tensors of the layout
    of `shape`), the Renderer's banded path
    (trident_tpu/parallel/framebuffer.py:311-352). The light camera is
    used when shadow_size is set; the shadow bias, the AI blend and the
    bone palette ride the blobs; `ai_image` ((H, W, 3) at display size, or
    (1, 1, 3)) is mixed in at the blob's blend, and with no ai_image there
    is no mix."""
    (params, palette, shade_table, camera, lights, light_cam, ai_blend,
     shadow_bias) = unpack_frame(f32, i32, shape)
    return render_frame_banded(
        devices, geometry, plan, tri_draw, params, palette, shade_table,
        camera, lights, textures, skybox,
        None if ai_image is None else AiBlend(ai_image, ai_blend),
        light_camera=light_cam if shadow_size else None, corner_t=corner_t,
        width=width, height=height, clear_color=clear_color,
        raster_mode=raster_mode, skinned=skinned, sampling=sampling, vertex_colors=vertex_colors, plane_f16=plane_f16,
        forward_shading=forward_shading, shadow_size=shadow_size,
        shadow_bias=shadow_bias, shadow_pcf=shadow_pcf,
        supersample=supersample, bloom=bloom,
        bloom_threshold=bloom_threshold, bloom_strength=bloom_strength,
        upscale_params=upscale_params, prev=prev, shader_fn=shader_fn,
        knobs=knobs)
