"""Fragment shading: Cook-Torrance PBR, bilinear texturing, tonemap.

Port of trident_tpu/ops/shading.py (the forward slice). Math is the
reference's GLSL (Default.frag): GGX distribution, Smith geometry with
k = (r+1)²/8, Schlick Fresnel, one (optionally shadowed) directional + up
to 8 point lights with squared edge falloff, roughness clamped to
[0.045, 1], F0 = mix(0.04, albedo, metallic), Reinhard tonemap + gamma 2.2. Texture sampling is the
flat quad-pyramid addressing of render/textures.py in the three modes of
the reference's sampling knob (nearest: one texel gather; bilinear: one
quad at the rounded mip; trilinear: a quad at each of the two mips around
the fractional one, lerped), and the skybox is a cube map sampled by
direction (sample_skybox).
"""

from __future__ import annotations

from typing import Optional

import torch

from trident_tpu_torch.render.types import LightParams, TextureArrays

Tensor = torch.Tensor
PI = 3.14159265359


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(v: Tensor, eps: float = 1e-8) -> Tensor:
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-1,
                                                     keepdim=True), eps))


def distribution_ggx(n: Tensor, h: Tensor, roughness: Tensor) -> Tensor:
    a = roughness * roughness
    a2 = a * a
    ndoth = torch.clamp_min(_dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv: Tensor, roughness: Tensor) -> Tensor:
    r = roughness + 1.0
    k = (r * r) / 8.0
    denom = ndotv * (1.0 - k) + k
    return ndotv / torch.clamp_min(denom, 1e-4)


def geometry_smith(n: Tensor, v: Tensor, l: Tensor,
                   roughness: Tensor) -> Tensor:
    ndotv = torch.clamp_min(_dot(n, v), 0.0)
    ndotl = torch.clamp_min(_dot(n, l), 0.0)
    return (geometry_schlick_ggx(ndotv, roughness)
            * geometry_schlick_ggx(ndotl, roughness))


def fresnel_schlick(cos_theta: Tensor, f0: Tensor) -> Tensor:
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0),
                                       5.0)


def evaluate_pbr_light(light_dir: Tensor, radiance: Tensor, normal: Tensor,
                       view_dir: Tensor, albedo: Tensor, metallic: Tensor,
                       roughness: Tensor, f0: Tensor) -> Tensor:
    """One light's contribution (Default.frag EvaluatePBRLighting)."""
    h = _normalize(view_dir + light_dir)
    ndf = distribution_ggx(normal, h, roughness)
    geom = geometry_smith(normal, view_dir, light_dir, roughness)
    fresnel = fresnel_schlick(torch.clamp_min(_dot(h, view_dir), 0.0), f0)
    numerator = ndf * geom * fresnel
    denominator = torch.clamp_min(
        4.0 * torch.clamp_min(_dot(normal, view_dir), 0.0)
        * torch.clamp_min(_dot(normal, light_dir), 0.0), 1e-4)
    specular = numerator / denominator
    kd = (1.0 - fresnel) * (1.0 - metallic)
    ndotl = torch.clamp_min(_dot(normal, light_dir), 0.0)
    return (kd * albedo / PI + specular) * radiance * ndotl


def shade_pbr(world: Tensor, normal: Tensor, albedo: Tensor, metallic: Tensor,
              roughness: Tensor, ambient_strength: Tensor, camera_pos: Tensor,
              lights: LightParams, dir_shadow: Optional[Tensor] = None
              ) -> Tensor:
    """Full lighting sum → linear HDR color. world/normal/albedo (...,3);
    metallic/roughness/ambient_strength (...,1). `dir_shadow` (...,1)
    multiplies the directional light (shadow mapping)."""
    metallic = torch.clamp(metallic, 0.0, 1.0)
    roughness = torch.clamp(roughness, 0.045, 1.0)
    ambient_strength = torch.clamp(ambient_strength, 0.0, 1.0)

    view_dir = _normalize(camera_pos - world)
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic

    dir_on = (lights.dir_count > 0).to(albedo.dtype)
    l_dir = _normalize(-lights.dir_direction).expand(world.shape)
    radiance = lights.dir_color[:3] * lights.dir_color[3]
    direct = dir_on * evaluate_pbr_light(
        l_dir, radiance, normal, view_dir, albedo, metallic, roughness, f0)
    if dir_shadow is not None:
        direct = direct * dir_shadow

    # point lights: one pass per (bucketed) slot, masked by point_count
    for i in range(lights.point_pos_range.shape[0]):
        on = (i < lights.point_count).to(albedo.dtype)
        to_light = lights.point_pos_range[i, :3] - world
        dist = torch.sqrt(torch.clamp_min(
            torch.sum(to_light * to_light, dim=-1, keepdim=True), 1e-12))
        near_zero = dist <= 1e-4
        l_vec = to_light / torch.where(near_zero, 1.0, dist)
        radius = torch.clamp_min(lights.point_pos_range[i, 3], 1e-4)
        norm_dist = torch.clamp(dist / radius, 0.0, 1.0)
        atten = (1.0 - norm_dist) ** 2
        radiance = (lights.point_color_intensity[i, :3]
                    * lights.point_color_intensity[i, 3] * atten)
        contrib = evaluate_pbr_light(
            l_vec, radiance, normal, view_dir, albedo, metallic, roughness, f0)
        direct = direct + on * torch.where(near_zero, 0.0, contrib)

    ambient = lights.ambient[:3] * lights.ambient[3] * albedo * ambient_strength
    return ambient + direct


def tonemap_reinhard_gamma(color: Tensor) -> Tensor:
    """color/(color+1) then gamma 1/2.2 (Default.frag:176-178)."""
    c = color / (color + 1.0)
    return torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2)


# -- texture sampling ---------------------------------------------------------
# entry(s,l,y,x) = quads[slot_base + level_base(E_s,l) + y·((E_s>>l)+1) + x]
# holding the 2×2 block; a bilinear tap is ONE quad fetch (ops/texel.py).

def _level_geom(level: Tensor, size_hint):
    """(lw, lh, stride, base) for per-pixel integer mip levels, closed form:
    a slot's level offset for pow2 edge E is Σ_{j<l}((E>>j)+1)²
    = (E²−(E>>l)²)·4/3 + 4(E−(E>>l)) + l. `size_hint` is the per-pixel
    (w0, h0, base>>8, edge) i32 rows (from the resolved attributes)."""
    w0, h0, base8, edge = size_hint
    lw = torch.clamp_min(torch.bitwise_right_shift(w0, level), 1)
    lh = torch.clamp_min(torch.bitwise_right_shift(h0, level), 1)
    es = torch.clamp_min(torch.bitwise_right_shift(edge, level), 1)
    stride = es + 1
    # clamp the additive level term to the slot's OWN pyramid depth (edge
    # is pow2, so log2 in f32 is exact)
    tail = torch.log2(torch.clamp_min(edge, 1).float()).to(level.dtype)
    base = ((base8 << 8)
            + torch.div((edge * edge - es * es) * 4, 3, rounding_mode="floor")
            + (edge - es) * 4 + torch.minimum(level, tail))
    return lw, lh, stride, base


def bilinear_index(uv: Tensor, level: Tensor, size_hint):
    """(idx, fx, fy) of the REPEAT-wrap bilinear quad fetch at integer mip
    `level`: the index math the texel kernel's callers share."""
    lw, lh, stride, base = _level_geom(level, size_hint)
    x = uv[..., 0] * lw.float() - 0.5
    y = uv[..., 1] * lh.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # floor modulo (jnp.mod) for the REPEAT wrap of negative coordinates
    x0i = torch.remainder(x0.to(torch.int32), lw)
    y0i = torch.remainder(y0.to(torch.int32), lh)
    return base + y0i * stride + x0i, fx, fy


def _bilinear_flat(tex: TextureArrays, uv: Tensor, level: Tensor,
                   size_hint) -> Tensor:
    """Bilinear sample with REPEAT wrap at integer mip `level`, one quad
    gather, plain PyTorch (the texel kernel's callers use ops/texel.py)."""
    from trident_tpu_torch.ops.texel import sample_bilinear_plain

    idx, fx, fy = bilinear_index(uv, level, size_hint)
    return sample_bilinear_plain(tex.quads, idx, fx, fy)


SAMPLING_MODES = ("nearest", "bilinear", "trilinear")


def _nearest_flat(tex: TextureArrays, uv: Tensor, level: Tensor,
                  size_hint) -> Tensor:
    """Nearest-texel sample with REPEAT wrap at integer mip `level`: one
    indexing gather of the texel's RGBA8 word, lane 0 of its quad
    (trident_tpu/ops/shading.py:_nearest_flat)."""
    from trident_tpu_torch.ops.texel import _unpack_rgba8

    lw, lh, stride, base = _level_geom(level, size_hint)
    xi = torch.remainder(torch.floor(uv[..., 0] * lw.float())
                         .to(torch.int32), lw)
    yi = torch.remainder(torch.floor(uv[..., 1] * lh.float())
                         .to(torch.int32), lh)
    v = tex.quads[(base + yi * stride + xi).long(), 0]
    return _unpack_rgba8(v) * (1.0 / 255.0)


def clamp_mip(tex: TextureArrays, mip_level: Tensor) -> Tensor:
    """The mip level clamped to [0, max level] (a graph-safe clamp: the
    bound is a device tensor)."""
    return torch.minimum(torch.clamp_min(mip_level, 0.0),
                         tex.max_level.float())


def trilinear_levels(mip: Tensor):
    """(lower level i32, lerp weight (..., 1)) of a clamped mip: the
    trilinear sample is bilinear at `lo` and `lo + 1`, mixed by `frac`."""
    lo = torch.floor(mip)
    return lo.to(torch.int32), (mip - lo)[..., None]


def sample_texture_mip(tex: TextureArrays, uv: Tensor, mip_level: Tensor,
                       size_hint) -> Tensor:
    """Trilinear sample: bilinear at the floor and floor + 1 mips, lerped
    (levels past a slot's own pyramid clamp to its 1×1 tail in
    _level_geom)."""
    lo_i, frac = trilinear_levels(clamp_mip(tex, mip_level))
    lo_samp = _bilinear_flat(tex, uv, lo_i, size_hint)
    hi_samp = _bilinear_flat(tex, uv, lo_i + 1, size_hint)
    return lo_samp * (1.0 - frac) + hi_samp * frac


def sample_texture(tex: TextureArrays, uv: Tensor, mip_level: Tensor,
                   mode: str = "bilinear", size_hint=None,
                   slot: Optional[Tensor] = None) -> Tensor:
    """Sample at the clamped mip level in `mode` (SAMPLING_MODES), plain
    PyTorch (trident_tpu/ops/shading.py:sample_texture): nearest and
    bilinear at the rounded level, trilinear between the two around it.
    `size_hint` is the per-pixel (w0, h0, base>>8, edge) i32 rows of the
    resolved attributes; without it, the per-pixel texture `slot` (an
    integer tensor of uv's leading shape) gives them by one gather of
    their tex.sizes rows, as the JAX function's _level_geom gathers."""
    if mode not in SAMPLING_MODES:
        raise ValueError(f"unknown sampling mode {mode!r}; expected one of "
                         f"{SAMPLING_MODES}")
    if size_hint is None:
        if slot is None:
            raise ValueError("sample_texture needs a size_hint or a slot")
        row = tex.sizes[slot.long()]
        size_hint = tuple(row[..., k] for k in range(4))
    mip = clamp_mip(tex, mip_level)
    if mode == "trilinear":
        return sample_texture_mip(tex, uv, mip, size_hint)
    mip_i = torch.round(mip).to(torch.int32)
    if mode == "nearest":
        return _nearest_flat(tex, uv, mip_i, size_hint)
    return _bilinear_flat(tex, uv, mip_i, size_hint)


def sample_skybox(faces: Tensor, direction: Tensor,
                  bilinear: bool = True) -> Tensor:
    """Cube map sample by direction (trident_tpu/ops/shading.py:270-315).
    faces: (6, E, E, 3) f32 ordered +x, −x, +y, −y, +z, −z; direction:
    (..., 3). Bilinear with clamp-to-edge inside the face by default,
    nearest with bilinear=False. The face is the major axis, x winning
    ties with y and z and y winning ties with z, as the reference decides
    edge pixels."""
    d = _normalize(direction)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3),
                    torch.where(z > 0, 4, 5)))
    ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                         1e-8)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    e = faces.shape[1]
    face = face.long()
    if not bilinear:
        xi = torch.clamp((u * e).to(torch.int64), 0, e - 1)
        yi = torch.clamp((v * e).to(torch.int64), 0, e - 1)
        return faces[face, yi, xi]
    fx = u * e - 0.5
    fy = v * e - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, 0, e - 1)
    y1i = torch.clamp(y0i + 1, 0, e - 1)
    x0i = torch.clamp(x0i, 0, e - 1)
    y0i = torch.clamp(y0i, 0, e - 1)
    top = faces[face, y0i, x0i] * (1.0 - wx) + faces[face, y0i, x1i] * wx
    bot = faces[face, y1i, x0i] * (1.0 - wx) + faces[face, y1i, x1i] * wx
    return top * (1.0 - wy) + bot * wy
