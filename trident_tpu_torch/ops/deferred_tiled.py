"""Tiled (channel-planar) deferred shading: shade in the raster's tile
layout, untile only the final RGBA (the `tiled_shade` knob).

Port of trident_tpu/ops/deferred_tiled.py. Every per-pixel quantity is a
(n_tiles, 1024) plane — a leading-axis slice of the tiled resolve output
(ops/resolve.py resolve_attrs_tiled, or the fused pass's attributes) — the
texel fetch is the planar texel kernel (ops/texel.py
sample_bilinear_planar), and only the (n_tiles, 4, 1024) frame is untiled
by the caller, which composes the background, alpha and clamp in (H, W).

The arithmetic is the JAX module's planar expression order (its
_normalize3, _pbr_light, _shadow_factor_planar and shade_attrs_tiled),
which reassociates ops/shading.py's: the two paths agree to rounding
noise, not bit for bit. The planar shadow factor takes its 1 or 4 taps
from the shadow-taps kernel (ops/shadow_taps.py) in place of the JAX
module's gathers: the same raw map bits at the same indices. World
positions are rebuilt from tile pixel coordinates in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch

from trident_tpu_torch.ops import raster
from trident_tpu_torch.ops import resolve as rp
from trident_tpu_torch.ops import shading
from trident_tpu_torch.ops.deferred import texel_lookup
from trident_tpu_torch.ops.shadow_taps import shadow_tap_bits
from trident_tpu_torch.ops.texel import sample_bilinear_planar
from trident_tpu_torch.render.types import (
    CameraParams,
    LightParams,
    ShadowParams,
    TextureArrays,
)

Tensor = torch.Tensor


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z, eps: float = 1e-8):
    inv = torch.rsqrt(torch.clamp_min(_dot3(x, y, z, x, y, z), eps))
    return x * inv, y * inv, z * inv


def _pbr_light(lx, ly, lz, rad_r, rad_g, rad_b, nx, ny, nz, vx, vy, vz,
               al_r, al_g, al_b, metallic, roughness, f0_r, f0_g, f0_b):
    """Planar twin of shading.evaluate_pbr_light (one light's
    contribution, Default.frag EvaluatePBRLighting)."""
    hx, hy, hz = _normalize3(vx + lx, vy + ly, vz + lz)
    ndoth = torch.clamp_min(_dot3(nx, ny, nz, hx, hy, hz), 0.0)
    a = roughness * roughness
    a2 = a * a
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    ndf = a2 / (shading.PI * denom * denom)

    ndotv = torch.clamp_min(_dot3(nx, ny, nz, vx, vy, vz), 0.0)
    ndotl = torch.clamp_min(_dot3(nx, ny, nz, lx, ly, lz), 0.0)
    r1 = roughness + 1.0
    k = (r1 * r1) / 8.0
    geom = (ndotv / torch.clamp_min(ndotv * (1.0 - k) + k, 1e-4)) \
        * (ndotl / torch.clamp_min(ndotl * (1.0 - k) + k, 1e-4))

    hdotv = torch.clamp_min(_dot3(hx, hy, hz, vx, vy, vz), 0.0)
    fres_p = torch.pow(torch.clamp(1.0 - hdotv, 0.0, 1.0), 5.0)
    fr = f0_r + (1.0 - f0_r) * fres_p
    fg = f0_g + (1.0 - f0_g) * fres_p
    fb = f0_b + (1.0 - f0_b) * fres_p

    spec_den = torch.clamp_min(4.0 * ndotv * ndotl, 1e-4)
    ng = ndf * geom / spec_den
    kd = (1.0 - metallic)
    inv_pi = 1.0 / shading.PI
    out_r = ((1.0 - fr) * kd * al_r * inv_pi + ng * fr) * rad_r * ndotl
    out_g = ((1.0 - fg) * kd * al_g * inv_pi + ng * fg) * rad_g * ndotl
    out_b = ((1.0 - fb) * kd * al_b * inv_pi + ng * fb) * rad_b * ndotl
    return out_r, out_g, out_b


def _shadow_factor_planar(shadow: ShadowParams, wx: Tensor, wy: Tensor,
                          wz: Tensor, pcf: bool) -> Tensor:
    """Planar twin of ops/shadow.shadow_factor → (n_tiles, 1024) in
    [0, 1], 1 = lit. The taps come from the shadow-taps kernel at the
    clipped map indices (−1, read as 0, outside the light frustum, where
    the factor is 1 anyway)."""
    s = shadow.depth.shape[0]
    m = shadow.light_vp
    cx = m[0, 0] * wx + m[0, 1] * wy + m[0, 2] * wz + m[0, 3]
    cy = m[1, 0] * wx + m[1, 1] * wy + m[1, 2] * wz + m[1, 3]
    cz = m[2, 0] * wx + m[2, 1] * wy + m[2, 2] * wz + m[2, 3]
    cw = m[3, 0] * wx + m[3, 1] * wy + m[3, 2] * wz + m[3, 3]
    safe_w = torch.where(cw.abs() < 1e-12, 1e-12, cw)
    u = (cx / safe_w + 1.0) * 0.5
    v = (cy / safe_w + 1.0) * 0.5
    depth = cz / safe_w
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (depth <= 1.0)
    test_depth = depth - shadow.bias

    def index(i):
        return torch.where(inside, torch.clamp(i, 0, s - 1),
                           -1).to(torch.int32).contiguous()

    if not pcf:
        taps = shadow_tap_bits(shadow.depth, index((v * s).to(torch.int32)),
                               index((u * s).to(torch.int32)))
    else:
        fx = u * s - 0.5
        fy = v * s - 0.5
        x0 = torch.floor(fx).to(torch.int32)
        y0 = torch.floor(fy).to(torch.int32)
        wxf = fx - x0.float()
        wyf = fy - y0.float()
        taps = shadow_tap_bits(shadow.depth, index(y0), index(x0),
                               index(y0 + 1), index(x0 + 1))
    f = taps.view(torch.float32)

    def tap(t):
        return torch.where(test_depth > f[..., t], 0.0, 1.0)

    if not pcf:
        lit = tap(0)
    else:
        lit = ((tap(0) * (1 - wxf) + tap(1) * wxf) * (1 - wyf)
               + (tap(2) * (1 - wxf) + tap(3) * wxf) * wyf)
    lit = torch.where(inside, lit, 1.0)
    return torch.where(shadow.enabled, lit, 1.0)


def shade_attrs_tiled(tri_tiles: Tensor, depth_tiles: Tensor,
                      attrs_t: Tensor, textures: TextureArrays,
                      camera: CameraParams, lights: LightParams, width: int,
                      height: int, shadow: Optional[ShadowParams] = None,
                      shadow_pcf: bool = False,
                      tonemap: bool = True, tile_y_offset: int = 0,
                      full_height: Optional[int] = None) -> Tensor:
    """(n_tiles, CHANNELS, 1024) resolved attrs of (n_tiles, 1024) winners
    and depths → (n_tiles, 4, 1024) frame: tonemapped (or linear HDR when
    tonemap=False) lit rgb + raw alpha. Background, alpha clear and clamp
    are the caller's, after the untile. A band of a full_height frame
    whose first tile row is global tile row tile_y_offset reconstructs its
    world positions at the full frame's pixel centres
    (trident_tpu/ops/deferred_tiled.py:140-141,196-205)."""
    nt = attrs_t.shape[0]
    ntx = -(-width // raster.TILE)

    def a(c):
        return attrs_t[:, c, :]

    nx, ny, nz = _normalize3(a(rp.CH_NX), a(rp.CH_NY), a(rp.CH_NZ))
    cf_r, cf_g, cf_b, cf_a = (a(rp.CH_CF), a(rp.CH_CF + 1),
                              a(rp.CH_CF + 2), a(rp.CH_CF + 3))
    metallic = torch.clamp(a(rp.CH_MET), 0.0, 1.0)
    roughness = torch.clamp(a(rp.CH_ROUGH), 0.045, 1.0)
    ambient_strength = torch.clamp(a(rp.CH_AMB), 0.0, 1.0)
    # the index math of the (H, W) path on the (nt, npx, CH) view: the
    # same elementwise ops, so the same (nt, npx) idx/fx/fy planes
    sampled = sample_bilinear_planar(
        textures.quads, *texel_lookup(attrs_t.permute(0, 2, 1),
                                      tri_tiles >= 0,
                                      textures.max_level))   # (nt, 4, npx)
    al_r = sampled[:, 0, :] * cf_r
    al_g = sampled[:, 1, :] * cf_g
    al_b = sampled[:, 2, :] * cf_b
    alpha = cf_a * sampled[:, 3, :]

    # world position from depth, at tile pixel centres
    px, py = raster.tile_centres(torch.arange(nt, device=attrs_t.device),
                                 ntx, tile_y_offset)
    vp_inv = torch.linalg.inv_ex(camera.proj @ camera.view).inverse
    fh = height if full_height is None else full_height
    ndc_x = px * (2.0 / width) - 1.0
    ndc_y = py * (2.0 / fh) - 1.0

    def wrow(c):
        return (vp_inv[c, 0] * ndc_x + vp_inv[c, 1] * ndc_y
                + vp_inv[c, 2] * depth_tiles + vp_inv[c, 3])

    wh = wrow(3)
    inv_wh = 1.0 / torch.where(wh.abs() < 1e-20, 1e-20, wh)
    wx, wy, wz = wrow(0) * inv_wh, wrow(1) * inv_wh, wrow(2) * inv_wh

    dir_shadow = None
    if shadow is not None:
        dir_shadow = _shadow_factor_planar(shadow, wx, wy, wz, shadow_pcf)

    # Cook-Torrance sum (shading.shade_pbr, planar)
    vx, vy, vz = _normalize3(camera.position[0] - wx,
                             camera.position[1] - wy,
                             camera.position[2] - wz)
    f0_r = 0.04 * (1.0 - metallic) + al_r * metallic
    f0_g = 0.04 * (1.0 - metallic) + al_g * metallic
    f0_b = 0.04 * (1.0 - metallic) + al_b * metallic

    dir_on = (lights.dir_count > 0).float()
    ld = shading._normalize(-lights.dir_direction)
    rad = lights.dir_color[:3] * lights.dir_color[3]
    dr, dg, db = _pbr_light(
        ld[0].expand(wx.shape), ld[1], ld[2], rad[0], rad[1], rad[2],
        nx, ny, nz, vx, vy, vz, al_r, al_g, al_b, metallic, roughness,
        f0_r, f0_g, f0_b)
    if dir_shadow is not None:
        dr, dg, db = dr * dir_shadow, dg * dir_shadow, db * dir_shadow
    out_r, out_g, out_b = dir_on * dr, dir_on * dg, dir_on * db

    for i in range(lights.point_pos_range.shape[0]):
        on = (i < lights.point_count).float()
        tx = lights.point_pos_range[i, 0] - wx
        ty = lights.point_pos_range[i, 1] - wy
        tz = lights.point_pos_range[i, 2] - wz
        dist = torch.sqrt(torch.clamp_min(_dot3(tx, ty, tz, tx, ty, tz),
                                          1e-12))
        near_zero = dist <= 1e-4
        inv_d = 1.0 / torch.where(near_zero, 1.0, dist)
        lx, ly, lz = tx * inv_d, ty * inv_d, tz * inv_d
        radius = torch.clamp_min(lights.point_pos_range[i, 3], 1e-4)
        atten = (1.0 - torch.clamp(dist / radius, 0.0, 1.0)) ** 2
        ci = lights.point_color_intensity[i]
        pr, pg, pb = _pbr_light(
            lx, ly, lz, ci[0] * ci[3] * atten, ci[1] * ci[3] * atten,
            ci[2] * ci[3] * atten, nx, ny, nz, vx, vy, vz,
            al_r, al_g, al_b, metallic, roughness, f0_r, f0_g, f0_b)
        zero = torch.where(near_zero, 0.0, 1.0) * on
        out_r = out_r + zero * pr
        out_g = out_g + zero * pg
        out_b = out_b + zero * pb

    amb = lights.ambient[:3] * lights.ambient[3]
    out_r = out_r + amb[0] * al_r * ambient_strength
    out_g = out_g + amb[1] * al_g * ambient_strength
    out_b = out_b + amb[2] * al_b * ambient_strength

    if tonemap:
        def tm(c):
            return torch.pow(torch.clamp_min(c / (c + 1.0), 0.0), 1.0 / 2.2)

        out_r, out_g, out_b = tm(out_r), tm(out_g), tm(out_b)

    return torch.stack([out_r, out_g, out_b, alpha], dim=1)   # (nt, 4, npx)
