"""Deferred shading: the resolved attribute image or the winner ids and
attribute planes → RGBA frame.

Port of trident_tpu/ops/deferred.py. Two entry points feed one shading
body (_shade_common, as in the JAX package): deferred_shade_attrs takes
the forward path's resolved attribute image (ops/resolve.py), and
deferred_shade the plane-gather path's winner ids, gathering two (three
with vertex colours) plane-table rows per pixel (ops/planes.py::
AttributePlanes, f32 or f16) and evaluating normal, UV, the analytic UV
derivatives → mip and the vertex colour at the anchored pixel centre.
Per pixel then: the texture sample in the frame's sampling mode
(bilinear: one texel quad fetch by the texel kernel, ops/texel.py;
trilinear: the texel kernel at the two mips around the fractional one,
lerped; nearest: one indexing gather), world position reconstructed from
depth through the inverse view-projection, the directional light's
shadow factor (ops/shadow.py) when a shadow map is given, Cook-Torrance
PBR or a custom shader (render/shader_hook.py), Reinhard tonemap + gamma
(or linear HDR out for bloom), the skybox or the clear color behind, then
the clamp. `apply_ai_blend` is the frame's final mix with the
interpolated AI frame, which render_frame applies once at display
resolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from trident_tpu_torch.ops import resolve as rp
from trident_tpu_torch.ops import shading
from trident_tpu_torch.ops.planes import AttributePlanes
from trident_tpu_torch.ops.shadow import shadow_factor
from trident_tpu_torch.ops.texel import sample_bilinear
from trident_tpu_torch.render.types import (
    AiBlend,
    CameraParams,
    GBuffer,
    LightParams,
    ShadowParams,
    SkyboxCube,
    TextureArrays,
)

Tensor = torch.Tensor


def _background(camera: CameraParams, skybox: Optional[SkyboxCube],
                width: int, height: int, clear_color, device) -> Tensor:
    """(H, W, 3) background (trident_tpu/ops/deferred.py:41-66): the
    skybox sampled along each pixel centre's world-space view ray, or the
    clear color without one (or where skybox.valid is False). The ray is
    the projective xy map inverted at z_view = −1 and turned by the view's
    3×3 rows, written out as three f32 products and sums. The clear color
    is a device fill per channel, not a host-to-device copy, so that a
    CUDA graph can capture it."""
    clear = torch.cat([torch.full((1,), c, dtype=torch.float32,
                                  device=device)
                       for c in clear_color[:3]]).expand(height, width, 3)
    if skybox is None:
        return clear
    ys = (torch.arange(height, dtype=torch.float32, device=device)
          + 0.5) / height * 2.0 - 1.0
    xs = (torch.arange(width, dtype=torch.float32, device=device)
          + 0.5) / width * 2.0 - 1.0
    ny, nx = torch.meshgrid(ys, xs, indexing="ij")
    x_v = (nx + camera.proj[0, 2]) / camera.proj[0, 0]
    y_v = (ny + camera.proj[1, 2]) / camera.proj[1, 1]
    rot = camera.view[:3, :3]
    dir_world = torch.stack(
        [x_v * rot[0, j] + y_v * rot[1, j] - rot[2, j] for j in range(3)],
        dim=-1)
    sky = shading.sample_skybox(skybox.faces, dir_world)
    return torch.where(skybox.valid, sky, clear)


def size_hint(attrs: Tensor) -> tuple:
    """Per-pixel (w0, h0, base >> 8, pow2 edge) i32 texture geometry from
    the resolved attributes: the edge is the bit-smeared pow2 ceil of
    max(w, h), exactly the packing of render/textures.py."""
    w0 = attrs[..., rp.CH_TSX].to(torch.int32)
    h0 = attrs[..., rp.CH_TSY].to(torch.int32)
    base8 = attrs[..., rp.CH_BASE8].to(torch.int32)
    m = torch.clamp_min(torch.maximum(w0, h0), 1) - 1
    for shift_k in (1, 2, 4, 8, 16):
        m = m | (m >> shift_k)
    return w0, h0, base8, m + 1


def texel_index(uv: Tensor, mip: Tensor, hint, covered: Tensor,
                max_level: Tensor):
    """(idx, fx, fy) of each pixel's bilinear quad fetch: the mip level
    clamped to [0, max_level] and rounded half to even, `hint` the
    per-pixel (w0, h0, base >> 8, edge) texture geometry, idx −1 where
    uncovered."""
    # clamp's tensor bound as torch.minimum: clamp(x, 0.0, t) would read
    # the 0-d t back to the host (a sync, which a CUDA graph cannot hold)
    mip = torch.minimum(torch.clamp_min(mip, 0.0), max_level.float())
    idx, fx, fy = shading.bilinear_index(
        uv, torch.round(mip).to(torch.int32), hint)
    idx = torch.where(covered, idx, -1)
    return idx.contiguous(), fx.contiguous(), fy.contiguous()


def texel_lookup(attrs: Tensor, covered: Tensor, max_level: Tensor):
    """texel_index of each pixel from its resolved attributes."""
    return texel_index(attrs[..., rp.CH_U:rp.CH_V + 1], attrs[..., rp.CH_MIP],
                       size_hint(attrs), covered, max_level)


def sample_texture_at(uv: Tensor, mip: Tensor, hint, covered: Tensor,
                      textures: TextureArrays,
                      sampling: str = "bilinear") -> Tensor:
    """(H, W, 4) texture sample of each pixel at its UV and fractional mip
    in `sampling` mode (shading.SAMPLING_MODES), `hint` the per-pixel
    texture geometry: bilinear is one texel kernel fetch at the rounded
    mip (texel_index), trilinear the texel kernel at the mips floor(mip)
    and floor(mip) + 1, lerped (the JAX package's two _bilinear_flat
    calls, shading.sample_texture_mip), and nearest one indexing gather
    (shading._nearest_flat; an uncovered pixel reads what its attributes
    address). Uncovered pixels are left to the caller's mask."""
    if sampling == "bilinear":
        return sample_bilinear(textures.quads,
                               *texel_index(uv, mip, hint, covered,
                                            textures.max_level))
    mip = shading.clamp_mip(textures, mip)
    if sampling == "nearest":
        return shading._nearest_flat(
            textures, uv, torch.round(mip).to(torch.int32), hint)
    if sampling != "trilinear":
        raise ValueError(f"unknown sampling mode {sampling!r}")
    lo, frac = shading.trilinear_levels(mip)
    samples = []
    for level in (lo, lo + 1):
        idx, fx, fy = shading.bilinear_index(uv, level, hint)
        samples.append(sample_bilinear(
            textures.quads, torch.where(covered, idx, -1).contiguous(),
            fx.contiguous(), fy.contiguous()))
    return samples[0] * (1.0 - frac) + samples[1] * frac


def sample_attrs_texture(attrs: Tensor, covered: Tensor,
                         textures: TextureArrays,
                         sampling: str = "bilinear") -> Tensor:
    """sample_texture_at each pixel's resolved UV, mip and texture
    geometry."""
    return sample_texture_at(attrs[..., rp.CH_U:rp.CH_V + 1],
                             attrs[..., rp.CH_MIP], size_hint(attrs),
                             covered, textures, sampling)


def world_positions(depth: Tensor, camera: CameraParams, width: int,
                    height: int) -> Tensor:
    """(H, W, 3) world position of each pixel centre from its depth:
    world_h = (P·V)⁻¹ · (ndc, 1), in f32 with TF32 off (pinned in the
    package __init__)."""
    dev = depth.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    # inv_ex: the same inverse as linalg.inv without its error check,
    # which waits for the device (and cannot be captured in a graph)
    vp_inv = torch.linalg.inv_ex(camera.proj @ camera.view).inverse
    ndc_x = px * (2.0 / width) - 1.0
    ndc_y = py * (2.0 / height) - 1.0
    ndc = torch.stack([ndc_x, ndc_y, depth, torch.ones_like(ndc_x)], dim=-1)
    world_h = ndc @ vp_inv.T
    wh = world_h[..., 3:4]
    return world_h[..., :3] / torch.where(wh.abs() < 1e-20, 1e-20, wh)


def deferred_shade_attrs(gbuffer: GBuffer, attrs: Tensor,
                         textures: TextureArrays, camera: CameraParams,
                         lights: LightParams, width: int, height: int,
                         clear_color=(0.05, 0.05, 0.08, 1.0),
                         shadow: Optional[ShadowParams] = None,
                         shadow_pcf: bool = False,
                         tonemap: bool = True,
                         skybox: Optional[SkyboxCube] = None,
                         sampling: str = "bilinear",
                         shader_fn=None) -> Tensor:
    """Shade from the resolved attribute image (ops/resolve.py channel
    layout) → (H, W, 4) f32 display-space frame in [0, 1]. The texture is
    sampled in `sampling` mode (sample_texture_at). `shadow` (the light
    pass's map) shadows the directional light, hard or 2×2 PCF.
    `shader_fn` (a custom shader's `shade`, render/shader_hook.py)
    replaces shade_pbr. `skybox` fills the uncovered pixels instead of the
    clear color. tonemap=False returns linear HDR instead (background
    treated as linear, no clamp) for bloom to work on."""
    return _shade_common(
        gbuffer, shading._normalize(attrs[..., rp.CH_NX:rp.CH_NZ + 1]),
        attrs[..., rp.CH_U:rp.CH_V + 1], attrs[..., rp.CH_MIP],
        size_hint(attrs), attrs[..., rp.CH_CF:rp.CH_CF + 4],
        attrs[..., rp.CH_MET:rp.CH_MET + 1],
        attrs[..., rp.CH_ROUGH:rp.CH_ROUGH + 1],
        attrs[..., rp.CH_AMB:rp.CH_AMB + 1], textures, camera, lights,
        width, height, clear_color, shadow, shadow_pcf, tonemap, skybox,
        sampling, shader_fn)


def deferred_shade(gbuffer: GBuffer, planes: AttributePlanes,
                   textures: TextureArrays, camera: CameraParams,
                   lights: LightParams, width: int, height: int,
                   clear_color=(0.05, 0.05, 0.08, 1.0),
                   shadow: Optional[ShadowParams] = None,
                   shadow_pcf: bool = False,
                   tonemap: bool = True,
                   skybox: Optional[SkyboxCube] = None,
                   sampling: str = "bilinear",
                   shader_fn=None) -> Tensor:
    """Shade the plane-gather frame (trident_tpu/ops/deferred.py:69-154):
    each pixel's plane_attributes, then what deferred_shade_attrs does."""
    return _shade_common(
        gbuffer, *plane_attributes(gbuffer, planes, textures, width, height),
        textures, camera, lights, width, height, clear_color, shadow,
        shadow_pcf, tonemap, skybox, sampling, shader_fn)


def plane_attributes(gbuffer: GBuffer, planes: AttributePlanes,
                     textures: TextureArrays, width: int, height: int):
    """(normal, uv, mip, texture geometry, colour factor, metallic,
    roughness, ambient strength) of each pixel from its winner's plane
    rows (f16 tables are widened to f32), evaluated at the pixel centre
    less the triangle's anchor: normal and UV as ratios over g1·p; the mip
    from the analytic UV derivatives (d(u)/dx = (gU_x − u·g1_x) / g1·p)
    scaled by the slot's level-0 size; the colour factor's rgb times the
    interpolated vertex colour when table_c is there. The slot's sizes row
    is gathered once and is the sampler's texture geometry."""
    dev = gbuffer.tri_id.device
    tri = gbuffer.tri_id.clamp_min(0).long()
    a = planes.table_a[tri].float()                            # (H,W,16)
    b = planes.table_b[tri].float()
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px_l = px - b[..., 11]
    py_l = py - b[..., 12]

    def dot_plane(t, j):                       # g·(px', py', 1), g at t[j:j+3]
        return t[..., j] * px_l + t[..., j + 1] * py_l + t[..., j + 2]

    denom = dot_plane(a, 0)
    inv = 1.0 / torch.where(denom.abs() < 1e-20, 1e-20, denom)
    normal = shading._normalize(torch.stack(
        [dot_plane(a, 3), dot_plane(a, 6), dot_plane(a, 9)], dim=-1)
        * inv[..., None])
    uv = torch.stack([dot_plane(a, 12), dot_plane(b, 0)], dim=-1) \
        * inv[..., None]
    color_factor = b[..., 3:7]
    if planes.table_c is not None:
        c = planes.table_c[tri].float()
        vcolor = torch.stack([dot_plane(c, 0), dot_plane(c, 3),
                              dot_plane(c, 6)], dim=-1) * inv[..., None]
        color_factor = torch.cat([color_factor[..., :3] * vcolor,
                                  color_factor[..., 3:4]], dim=-1)
    g1x, g1y = a[..., 0], a[..., 1]
    du_dx = (a[..., 12] - uv[..., 0] * g1x) * inv
    du_dy = (a[..., 13] - uv[..., 0] * g1y) * inv
    dv_dx = (b[..., 0] - uv[..., 1] * g1x) * inv
    dv_dy = (b[..., 1] - uv[..., 1] * g1y) * inv
    size_row = textures.sizes[b[..., 10].to(torch.int32).long()]
    tsx, tsy = size_row[..., 0].float(), size_row[..., 1].float()
    ax, bx = du_dx * tsx, dv_dx * tsy
    ay, by = du_dy * tsx, dv_dy * tsy
    rho = torch.maximum(ax * ax + bx * bx, ay * ay + by * by)
    mip = 0.5 * torch.log2(torch.clamp_min(rho, 1e-12))
    return (normal, uv, mip, size_row.unbind(-1), color_factor, b[..., 7:8],
            b[..., 8:9], b[..., 9:10])


def _shade_common(gbuffer: GBuffer, normal: Tensor, uv: Tensor, mip: Tensor,
                  hint, color_factor: Tensor, metallic: Tensor,
                  roughness: Tensor, ambient_strength: Tensor,
                  textures: TextureArrays, camera: CameraParams,
                  lights: LightParams, width: int, height: int, clear_color,
                  shadow: Optional[ShadowParams], shadow_pcf: bool,
                  tonemap: bool, skybox: Optional[SkyboxCube], sampling: str,
                  shader_fn) -> Tensor:
    """Texture sample + lighting + background/tonemap, shared by both
    entry points (trident_tpu/ops/deferred.py:201-286): normal
    (normalized), uv, fractional mip and texture geometry `hint` per
    pixel; color factor (..., 4), metallic, roughness and ambient strength
    (..., 1)."""
    dev = normal.device
    covered = gbuffer.tri_id >= 0
    sampled = sample_texture_at(uv, mip, hint, covered, textures, sampling)
    albedo = sampled[..., :3] * color_factor[..., :3]
    alpha = color_factor[..., 3:4] * sampled[..., 3:4]

    world = world_positions(gbuffer.depth, camera, width, height)
    dir_shadow = (None if shadow is None
                  else shadow_factor(shadow, world, pcf=shadow_pcf))
    shade = shading.shade_pbr if shader_fn is None else shader_fn
    lit = shade(world, normal, albedo, metallic, roughness, ambient_strength,
                camera.position, lights, dir_shadow=dir_shadow)
    background = _background(camera, skybox, width, height, clear_color, dev)
    a_out = torch.where(covered[..., None], alpha, clear_color[3])
    if not tonemap:
        rgb = torch.where(covered[..., None], lit, background)
        return torch.cat([rgb, a_out], dim=-1)
    rgb = torch.where(covered[..., None], shading.tonemap_reinhard_gamma(lit),
                      background)
    out = apply_ai_blend(torch.cat([rgb, a_out], dim=-1), None)
    return torch.clamp(out, 0.0, 1.0)


def apply_ai_blend(out: Tensor, ai: Optional[AiBlend]) -> Tensor:
    """The final display-space mix with the interpolated AI frame
    (trident_tpu/ops/deferred.py::apply_ai_blend): the blend clipped to
    [0, 1], the image given alpha 1, then out·(1 − blend) + image·blend.
    A (1, 1, 3) image broadcasts; blend 0 leaves `out` as it is, bit for
    bit. ai None is no mix."""
    if ai is None:
        return out
    blend = torch.clamp(ai.blend, 0.0, 1.0)
    ai_rgba = torch.cat([ai.image, torch.ones_like(ai.image[..., :1])],
                        dim=-1)
    return out * (1.0 - blend) + ai_rgba * blend


def pack_rgba8(frame: Tensor) -> Tensor:
    return torch.round(frame * 255.0).to(torch.uint8)
