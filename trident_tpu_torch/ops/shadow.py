"""Directional-light shadow mapping: the two-pass render graph.

Port of trident_tpu/ops/shadow.py. Pass 1 renders a light-POV depth map
with the main view's own geometry path (rigid frames: draw rows → corner
stage; skinned frames: the indexed vertex stage at the light camera →
triangle setup) and raster (binning → the visibility kernel's depth-only
instance, or the reference raster under use_pallas=False). Pass 2 (in
deferred shading) projects each pixel's reconstructed world position into
light clip space and compares it with one map texel (hard) or the four of
a 2×2 PCF footprint, fetched by the shadow-taps kernel
(ops/shadow_taps.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch.mathx.transforms import look_at, ortho_rh_zo
from trident_tpu_torch.ops import raster
from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage
from trident_tpu_torch.ops.raster_ref import visibility_ref
from trident_tpu_torch.ops.shadow_taps import shadow_tap_bits
from trident_tpu_torch.ops.vertex import triangle_setup_cols, vertex_stage
from trident_tpu_torch.render.types import CameraParams, ShadowParams

Tensor = torch.Tensor


def light_camera(direction: np.ndarray, center: np.ndarray,
                 radius: float) -> CameraParams:
    """Orthographic light camera covering a bounding sphere, as numpy
    arrays on the host (render/types.from_numpy puts it on a device)."""
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-8)
    center = np.asarray(center, np.float32)
    radius = max(float(radius), 1e-3)
    eye = center - d * radius * 2.0
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(d @ up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    view = np.asarray(look_at(eye, center, up), np.float32)
    proj = np.asarray(ortho_rh_zo(-radius, radius, -radius, radius,
                                  0.01, radius * 4.0), np.float32)
    return CameraParams(view=view, proj=proj,
                        position=np.asarray(eye, np.float32))


def _mesh_box_corners(packed, mesh_index: int):
    """(8, 4) homogeneous corners of one mesh's object-space bbox, or None
    for an empty mesh."""
    info = packed.draw_infos[mesh_index]
    first = info.base_vertex
    idx = packed.indices[info.first_index:info.first_index + info.index_count]
    count = int(idx.max()) + 1 if info.index_count else 0
    if count == 0:
        return None
    verts = packed.positions[first:first + count]
    mlo, mhi = verts.min(axis=0), verts.max(axis=0)
    return np.array([[x, y, z, 1.0]
                     for x in (mlo[0], mhi[0])
                     for y in (mlo[1], mhi[1])
                     for z in (mlo[2], mhi[2])], np.float32)


def scene_bounds(records, packed,
                 box_cache: Dict[int, np.ndarray] = None
                 ) -> Tuple[np.ndarray, float]:
    """(center, radius) of the drawn scene — the world-space union of the
    transformed per-mesh bboxes. `box_cache` (mesh index → bbox corners,
    valid for one packed geometry) keeps each mesh's bbox across calls;
    the result is the same either way."""
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    boxes = {} if box_cache is None else box_cache
    for rec in records:
        if rec.mesh_index not in boxes:
            boxes[rec.mesh_index] = _mesh_box_corners(packed, rec.mesh_index)
        corners = boxes[rec.mesh_index]
        if corners is None:
            continue
        world = corners @ rec.model.T
        lo = np.minimum(lo, world[:, :3].min(axis=0))
        hi = np.maximum(hi, world[:, :3].max(axis=0))
    if not np.isfinite(lo).all():
        return np.zeros(3, np.float32), 1.0
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center)) + 1e-3
    return center, radius


def render_shadow_map(plan, params, light_cam: CameraParams, size: int, *,
                      corner_t, tri_draw, draw_stride: int = 0,
                      real_draws: int = 0, ck_bank: int = 0,
                      pair_budget: Optional[int] = None, geometry=None,
                      palette=None, skinned: bool = False,
                      raster_mode: str = "pallas") -> Tuple[Tensor, Tensor]:
    """Depth-only render from the light → ((S, S) f32 depth in [0, 1],
    (2,) i32 aux of the light pass's binning, zero under the reference
    raster). The JAX package drops the aux; the depth is the same either
    way (trident_tpu/ops/shadow.py:73-112).

    Geometry: the corner stage when `corner_t` is given and the frame is
    not `skinned`; else the indexed vertex stage (`geometry`, the device
    GeometryBuffers, and `palette`, the frame's bone palette) at the light
    camera. Raster: `raster_mode` "ref" is the reference raster (chunk
    64); "pallas" bins and runs the depth-only kernel, or with ck_bank > 0
    (the ckern knob) the compact-bank kernel, its ids dropped as the JAX
    light pass drops them under CKERN (raster_pallas.py:1371: no
    depth-only body); its depths equal the depth-only kernel's.
    `pair_budget` is build_bins' pair cap (the pair_budget knob)."""
    if corner_t is not None and tri_draw is not None and not skinned:
        draw_rows = build_draw_rows(params, light_cam, size, size)
        cs = corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid,
                          size, size, draw_stride=draw_stride,
                          real_draws=real_draws)
        setup, setup_cols = cs.setup, cs.cols.setup
    else:
        verts = vertex_stage(geometry, plan, params, light_cam, palette,
                             skinned=skinned)
        setup, setup_cols = triangle_setup_cols(verts.clip, plan.tri_vtx,
                                                plan.tri_valid, size, size)
    if raster_mode == "ref":
        gbuf = visibility_ref(setup, size, size)
        return gbuf.depth, gbuf.aux
    bins = raster.build_bins(setup, size, size, setup_cols=setup_cols,
                             ck_bank=ck_bank, pair_budget=pair_budget)
    ntx = nty = -(-size // raster.TILE)
    if ck_bank:
        depth_t, _tri = raster.visibility_ck_tiles(bins, ntx, ntx * nty,
                                                   ck_bank)
    else:
        depth_t = raster.visibility_tiles(bins, ntx, ntx * nty,
                                          depth_only=True)
    return raster.untile_frame(depth_t, ntx, nty)[:size, :size], bins.aux


def null_shadow(size: int = 1, device=None) -> ShadowParams:
    """A disabled shadow: an all-far size × size map, identity light
    matrix, bias 2e-3 (trident_tpu/ops/shadow.py:195), on `device` (the
    CPU unless given); shadow_factor is 1 everywhere under it."""
    return ShadowParams(
        depth=torch.ones((size, size), dtype=torch.float32, device=device),
        light_vp=torch.eye(4, dtype=torch.float32, device=device),
        enabled=torch.zeros((), dtype=torch.bool, device=device),
        bias=torch.full((), 2e-3, dtype=torch.float32, device=device))


def _light_space(shadow: ShadowParams, world: Tensor):
    """(u, v, inside, test_depth) of world points in the light's map."""
    pos_h = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    clip = pos_h @ shadow.light_vp.T
    safe_w = torch.where(clip[..., 3:4].abs() < 1e-12, 1e-12, clip[..., 3:4])
    ndc = clip[..., :3] / safe_w
    u = (ndc[..., 0] + 1.0) * 0.5
    v = (ndc[..., 1] + 1.0) * 0.5
    depth = ndc[..., 2]
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (depth <= 1.0)
    return u, v, inside, depth - shadow.bias


def _indices(s: int, u: Tensor, v: Tensor, inside: Tensor, pcf: bool):
    """(tap indices, (x0, y0) unclipped PCF floors or None): the indices
    are (H, W) i32, −1 where the point is outside the light frustum."""
    def masked(i):
        return torch.where(inside, torch.clamp(i, 0, s - 1),
                           -1).to(torch.int32).contiguous()

    if not pcf:
        return (masked((v * s).to(torch.int32)),
                masked((u * s).to(torch.int32))), None
    x0 = torch.floor(u * s - 0.5).to(torch.int32)
    y0 = torch.floor(v * s - 0.5).to(torch.int32)
    return tuple(masked(i) for i in (y0, x0, y0 + 1, x0 + 1)), (x0, y0)


def tap_indices(shadow: ShadowParams, world: Tensor, pcf: bool = False):
    """The shadow-taps kernel's inputs for world points (H, W, 3): (y0, x0)
    (hard) or (y0, x0, y1, x1) (PCF) (H, W) i32 map indices, −1 outside
    the light frustum."""
    u, v, inside, _test = _light_space(shadow, world)
    return _indices(shadow.depth.shape[0], u, v, inside, pcf)[0]


def shadow_factor(shadow: ShadowParams, world: Tensor,
                  pcf: bool = False) -> Tensor:
    """Per-pixel directional shadow term (..., 1) in [0, 1]: 1 = lit.

    pcf=False: one tap, hard edges. pcf=True: 2×2 bilinear
    percentage-closer filtering — each tap is compared BEFORE the blend.
    The compare, lerp and masks follow the JAX function's expression
    order; the taps come from the shadow-taps kernel."""
    s = shadow.depth.shape[0]
    u, v, inside, test_depth = _light_space(shadow, world)
    idx, floors = _indices(s, u, v, inside, pcf)
    f = shadow_tap_bits(shadow.depth, *idx).view(torch.float32)

    def tap(t):
        return torch.where(test_depth > f[..., t], 0.0, 1.0)

    if not pcf:
        lit = tap(0)
    else:
        x0, y0 = floors
        wx = (u * s - 0.5) - x0.float()
        wy = (v * s - 0.5) - y0.float()
        lit = ((tap(0) * (1 - wx) + tap(1) * wx) * (1 - wy)
               + (tap(2) * (1 - wx) + tap(3) * wx) * wy)
    lit = torch.where(inside, lit, 1.0)
    return torch.where(shadow.enabled, lit, 1.0)[..., None]
