"""Deferred shading of the resolved attribute image → RGBA frame.

Port of trident_tpu/ops/deferred.py (the forward path: deferred_shade_attrs
with the forward branch of _shade_common folded in). Per pixel: the
texture sample in the frame's sampling mode (bilinear: one texel quad
fetch by the texel kernel, ops/texel.py; trilinear: the texel kernel at
the two mips around the fractional one, lerped; nearest: one indexing
gather), world position reconstructed from depth through the inverse
view-projection, the directional light's shadow factor (ops/shadow.py)
when a shadow map is given, Cook-Torrance PBR or a custom shader
(render/shader_hook.py), Reinhard tonemap + gamma (or linear HDR out for
bloom), the skybox or the clear color behind, then the clamp.
`apply_ai_blend` is the frame's final mix with the interpolated AI frame,
which render_frame applies once at display resolution.
"""

from __future__ import annotations

from typing import Optional

import torch

from trident_tpu_torch.ops import resolve as rp
from trident_tpu_torch.ops import shading
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


def texel_lookup(attrs: Tensor, covered: Tensor, max_level: Tensor):
    """(idx, fx, fy) of each pixel's bilinear quad fetch from the resolved
    attributes: the mip level clamped and rounded half to even, the
    texture geometry from the attribute image, idx −1 where uncovered."""
    # clamp's tensor bound as torch.minimum: clamp(x, 0.0, t) would read
    # the 0-d t back to the host (a sync, which a CUDA graph cannot hold)
    mip = torch.minimum(torch.clamp_min(attrs[..., rp.CH_MIP], 0.0),
                        max_level.float())
    idx, fx, fy = shading.bilinear_index(
        attrs[..., rp.CH_U:rp.CH_V + 1], torch.round(mip).to(torch.int32),
        size_hint(attrs))
    idx = torch.where(covered, idx, -1)
    return idx.contiguous(), fx.contiguous(), fy.contiguous()


def sample_attrs_texture(attrs: Tensor, covered: Tensor,
                         textures: TextureArrays,
                         sampling: str = "bilinear") -> Tensor:
    """(H, W, 4) texture sample of each pixel from its resolved attributes
    in `sampling` mode (shading.SAMPLING_MODES): bilinear is one texel
    kernel fetch at the rounded mip (texel_lookup), trilinear the texel
    kernel at the mips floor(mip) and floor(mip) + 1, lerped (the JAX
    package's two _bilinear_flat calls, shading.sample_texture_mip), and
    nearest one indexing gather (shading._nearest_flat; an uncovered
    pixel's zero attributes read entry 0). Uncovered pixels are left to
    the caller's mask."""
    if sampling == "bilinear":
        return sample_bilinear(textures.quads,
                               *texel_lookup(attrs, covered,
                                             textures.max_level))
    hint = size_hint(attrs)
    uv = attrs[..., rp.CH_U:rp.CH_V + 1]
    mip = shading.clamp_mip(textures, attrs[..., rp.CH_MIP])
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
    sampled in `sampling` mode (sample_attrs_texture). `shadow` (the light
    pass's map) shadows the directional light, hard or 2×2 PCF.
    `shader_fn` (a custom shader's `shade`, render/shader_hook.py)
    replaces shade_pbr. `skybox` fills the uncovered pixels instead of the
    clear color. tonemap=False returns linear HDR instead (background
    treated as linear, no clamp) for bloom to work on."""
    dev = attrs.device
    covered = gbuffer.tri_id >= 0
    sampled = sample_attrs_texture(attrs, covered, textures, sampling)
    color_factor = attrs[..., rp.CH_CF:rp.CH_CF + 4]
    albedo = sampled[..., :3] * color_factor[..., :3]
    alpha = color_factor[..., 3:4] * sampled[..., 3:4]

    world = world_positions(gbuffer.depth, camera, width, height)
    dir_shadow = (None if shadow is None
                  else shadow_factor(shadow, world, pcf=shadow_pcf))
    shade = shading.shade_pbr if shader_fn is None else shader_fn
    lit = shade(
        world, shading._normalize(attrs[..., rp.CH_NX:rp.CH_NZ + 1]), albedo,
        attrs[..., rp.CH_MET:rp.CH_MET + 1],
        attrs[..., rp.CH_ROUGH:rp.CH_ROUGH + 1],
        attrs[..., rp.CH_AMB:rp.CH_AMB + 1], camera.position, lights,
        dir_shadow=dir_shadow)
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
