"""The plain reference renderer: clip-space triangles → RGBA8 frame, in
float32 PyTorch with no kernel, no binning and no cache.

It follows the published rules of the frame the program renders (the
reference engine's Vulkan forward pass): homogeneous (2DH) edge functions
at pixel centres, counter-clockwise front faces, depth z/w in [0, 1] with
the nearest winning and, on an exact tie, the later triangle; perspective-
correct interpolation; the texture's box-filtered mip chain sampled
bilinearly with REPEAT wrap at the mip level its screen-space UV
derivatives ask for, rounded; Cook-Torrance PBR (GGX, Smith with
k = (r + 1)²/8, Schlick) for one directional light plus ambient;
Reinhard tonemap and gamma 2.2; the clear colour behind.

Every matrix product goes through `matmul`, so that the control
(`control=True`) computes the same frame in TF32: each operand's mantissa
rounded to 10 bits, products summed in float32.

Nothing here imports the program or takes anything the program made.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

PI = 3.14159265359
PAIR_BUDGET = 1 << 23       # (triangle, pixel) pairs evaluated at a time
NO_KEY = (1 << 63) - 1


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest even), kept in f32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    """a @ b in float32, or in TF32 under the control."""
    if control:
        a, b = tf32(a), tf32(b)
    return a @ b


def cofactor3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of (..., 3, 3): the normal transform cof(M) ∝ M⁻ᵀ."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.stack([torch.linalg.cross(r1, r2),
                        torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], dim=-2)


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min((v * v).sum(-1, keepdim=True),
                                           eps))


class Mesh(NamedTuple):
    """A frame's geometry, every instance already placed: per vertex the
    clip position (V, 4), world position (V, 3), unit world normal (V, 3),
    UV (V, 2) and colour (V, 3) or None; triangles (T, 3) vertex indices
    in draw order (later wins ties)."""

    clip: torch.Tensor
    world: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    color: Optional[torch.Tensor]
    tris: torch.Tensor


class Shading(NamedTuple):
    """What shades every triangle: the material (base colour rgba,
    metallic, roughness, ambient strength), the texture's mip chain
    (level 0 first, each (h, w, 4) uint8), the directional light
    (direction, colour, intensity), the ambient light rgba, the camera
    position and the clear colour rgba."""

    base_color: tuple
    metallic: float
    roughness: float
    ambient_strength: float
    mips: list
    light_dir: tuple
    light_color: tuple
    light_intensity: float
    ambient: tuple
    camera_pos: tuple
    clear_color: tuple


def mip_chain(img) -> list:
    """The texture's levels down to 1×1: each a 2×2 box mean of the last,
    rounded half to even (a square power-of-two image)."""
    levels = [torch.as_tensor(img, dtype=torch.uint8)]
    while levels[-1].shape[0] > 1:
        p = levels[-1].float()
        q = (p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2]
             + p[1::2, 1::2]) * 0.25
        levels.append(torch.clamp(torch.round(q), 0, 255).to(torch.uint8))
    return levels


class Visibility(NamedTuple):
    tri: torch.Tensor        # (H, W) i64 winner, −1 background
    depth: torch.Tensor      # (H, W) f32 winner depth (1 on background)
    edges: torch.Tensor      # (T, 3, 3) edge rows (a, b, c) per triangle


def setup(clip: torch.Tensor, tris: torch.Tensor, width: int, height: int):
    """(edges (T, 3, 3), z (T, 3), w (T, 3), bbox (T, 4) i64, valid (T,)):
    edge k is vertex j × vertex l of the viewport-scaled homogeneous
    corners (sx, sy, w), so e_k ≥ 0 inside a front-facing triangle; the
    bbox holds every pixel centre the triangle can cover (the whole frame
    for one that reaches behind the eye)."""
    c = clip[tris]                                            # (T, 3, 4)
    w = c[..., 3]
    sx = (c[..., 0] + w) * (0.5 * width)
    sy = (c[..., 1] + w) * (0.5 * height)
    v = torch.stack([sx, sy, w], dim=-1)                      # (T, 3, 3)
    edges = torch.stack([torch.linalg.cross(v[:, 1], v[:, 2]),
                         torch.linalg.cross(v[:, 2], v[:, 0]),
                         torch.linalg.cross(v[:, 0], v[:, 1])], dim=1)
    det = (v[:, 0] * edges[:, 0]).sum(-1)
    behind = (w <= 1e-6).any(dim=1)
    ws = torch.where(w.abs() < 1e-8, 1e-8, w)
    px, py = sx / ws, sy / ws
    x0 = torch.where(behind, 0.0, torch.floor(px.amin(1)))
    y0 = torch.where(behind, 0.0, torch.floor(py.amin(1)))
    x1 = torch.where(behind, float(width), torch.ceil(px.amax(1)) + 1.0)
    y1 = torch.where(behind, float(height), torch.ceil(py.amax(1)) + 1.0)
    bbox = torch.stack([x0.clamp(0, width), y0.clamp(0, height),
                        x1.clamp(0, width), y1.clamp(0, height)],
                       dim=-1).long()
    valid = ((det > 1e-12) & (bbox[:, 2] > bbox[:, 0])
             & (bbox[:, 3] > bbox[:, 1]))
    return edges, c[..., 2], w, bbox, valid


def visibility(clip: torch.Tensor, tris: torch.Tensor, width: int,
               height: int) -> Visibility:
    """Every valid triangle against every pixel centre of its bbox, a
    budget of pairs at a time; each pixel keeps the (nearest depth, then
    latest triangle) of those that cover it: all three edge values ≥ 0,
    w > 0 and 0 ≤ z ≤ w there."""
    dev = clip.device
    edges, z, w, bbox, valid = setup(clip, tris, width, height)
    ids = torch.nonzero(valid).squeeze(1)
    bw = bbox[ids, 2] - bbox[ids, 0]
    counts = bw * (bbox[ids, 3] - bbox[ids, 1])
    ends = torch.cumsum(counts, 0)
    keys = torch.full((height * width,), NO_KEY, dtype=torch.int64,
                      device=dev)
    start = 0
    while start < ids.numel():
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + PAIR_BUDGET, right=True))
        stop = max(stop, start + 1)
        sl = slice(start, stop)
        n = counts[sl]
        local_t = torch.repeat_interleave(
            torch.arange(stop - start, device=dev), n)
        first = torch.cumsum(n, 0) - n
        r = torch.arange(int(n.sum()), device=dev) - first[local_t]
        t = ids[sl][local_t]
        x = bbox[t, 0] + r % bw[sl][local_t]
        y = bbox[t, 1] + r // bw[sl][local_t]
        pxf = x.float() + 0.5
        pyf = y.float() + 0.5
        e = edges[t]                                          # (P, 3, 3)
        ev = e[..., 0] * pxf[:, None] + e[..., 1] * pyf[:, None] + e[..., 2]
        zi = (ev[:, 0] * z[t, 0] + ev[:, 1] * z[t, 1]) + ev[:, 2] * z[t, 2]
        wi = (ev[:, 0] * w[t, 0] + ev[:, 1] * w[t, 1]) + ev[:, 2] * w[t, 2]
        cover = ((ev >= 0.0).all(dim=1) & (wi > 1e-12) & (zi >= 0.0)
                 & (zi <= wi))
        depth = zi / torch.where(cover, wi, 1.0) + 0.0
        key = ((depth.view(torch.int32).long() << 32)
               | (0x7FFFFFFF - t))
        keys.scatter_reduce_(0, (y * width + x)[cover], key[cover], "amin")
        start = stop
    hit = keys != NO_KEY
    tri = torch.where(hit, 0x7FFFFFFF - (keys & 0xFFFFFFFF), -1)
    depth = torch.where(hit, (keys >> 32).to(torch.int32).view(
        torch.float32), 1.0)
    return Visibility(tri.view(height, width), depth.view(height, width),
                      edges)


def sample_bilinear(mips: list, uv: torch.Tensor,
                    level: torch.Tensor) -> torch.Tensor:
    """(N, 4) texel colour in [0, 1] at each UV (N, 2) on its mip level
    (N,) i64: the four texels around u·w − ½, v·h − ½ with REPEAT wrap,
    mixed in x then y."""
    dev = uv.device
    flat = torch.cat([m.reshape(-1, 4).to(dev) for m in mips]).float()
    sizes = torch.tensor([m.shape[1] for m in mips], device=dev)
    offsets = torch.cumsum(sizes * sizes, 0) - sizes * sizes
    lw = sizes[level]
    base = offsets[level]
    x = uv[:, 0] * lw.float() - 0.5
    y = uv[:, 1] * lw.float() - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi = torch.remainder(x0.long(), lw)
    yi = torch.remainder(y0.long(), lw)
    xj = torch.remainder(xi + 1, lw)
    yj = torch.remainder(yi + 1, lw)

    def tex(xx, yy):
        return flat[base + yy * lw + xx]

    top = tex(xi, yi) * (1.0 - fx) + tex(xj, yi) * fx
    bot = tex(xi, yj) * (1.0 - fx) + tex(xj, yj) * fx
    return (top * (1.0 - fy) + bot * fy) * (1.0 / 255.0)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def pbr(world, normal, albedo, s: Shading) -> torch.Tensor:
    """Linear HDR colour: the ambient term plus one directional light
    under Cook-Torrance (GGX distribution, Smith-Schlick geometry with
    k = (r + 1)²/8, Schlick Fresnel with F0 = mix(0.04, albedo,
    metallic))."""
    dev = world.device

    def vec(t):
        return torch.tensor(t, dtype=torch.float32, device=dev)

    metallic = min(max(s.metallic, 0.0), 1.0)
    rough = min(max(s.roughness, 0.045), 1.0)
    amb_k = min(max(s.ambient_strength, 0.0), 1.0)
    view = normalize(vec(s.camera_pos) - world)
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    d = vec(s.light_dir)
    d = d / torch.linalg.norm(d)
    light = normalize(-d).expand(world.shape)
    radiance = vec(s.light_color) * s.light_intensity
    h = normalize(view + light)
    a2 = (rough * rough) ** 2
    ndoth = torch.clamp_min(_dot(normal, h), 0.0)
    den = ndoth * ndoth * (a2 - 1.0) + 1.0
    ndf = a2 / (PI * den * den)
    k = (rough + 1.0) ** 2 / 8.0
    ndotv = torch.clamp_min(_dot(normal, view), 0.0)
    ndotl = torch.clamp_min(_dot(normal, light), 0.0)

    def g1(x):
        return x / torch.clamp_min(x * (1.0 - k) + k, 1e-4)

    fresnel = f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - torch.clamp_min(_dot(h, view), 0.0), 0.0, 1.0), 5.0)
    spec = ndf * g1(ndotv) * g1(ndotl) * fresnel / torch.clamp_min(
        4.0 * ndotv * ndotl, 1e-4)
    kd = (1.0 - fresnel) * (1.0 - metallic)
    direct = (kd * albedo / PI + spec) * radiance * ndotl
    amb = vec(s.ambient)
    return amb[:3] * amb[3] * albedo * amb_k + direct


def render(mesh: Mesh, s: Shading, width: int, height: int) -> dict:
    """The frame: {"color": (H, W, 4) uint8, "depth": (H, W) f32,
    "tri": (H, W) i64 winners (−1 background)}."""
    vis = visibility(mesh.clip, mesh.tris, width, height)
    dev = mesh.clip.device
    flat_tri = vis.tri.reshape(-1)
    pix = torch.nonzero(flat_tri >= 0).squeeze(1)
    t = flat_tri[pix]
    pxf = (pix % width).float() + 0.5
    pyf = (pix // width).float() + 0.5
    e = vis.edges[t]                                          # (N, 3, 3)
    ev = e[..., 0] * pxf[:, None] + e[..., 1] * pyf[:, None] + e[..., 2]
    g = ev.sum(1, keepdim=True)
    g = torch.where(g.abs() < 1e-20, 1e-20, g)
    lam = ev / g                                              # (N, 3)
    corners = mesh.tris[t]                                    # (N, 3)

    def interp(attr):
        return (lam[..., None] * attr[corners]).sum(1)

    normal = normalize(interp(mesh.normal))
    world = interp(mesh.world)
    uv = interp(mesh.uv)
    # d(u)/dx of u = Σ e_k u_k / Σ e_k, with de_k/dx = a_k, de_k/dy = b_k
    uvc = mesh.uv[corners]                                    # (N, 3, 2)
    gx = e[..., 0].sum(1, keepdim=True)
    gy = e[..., 1].sum(1, keepdim=True)
    du_dx = ((e[..., 0:1] * uvc).sum(1) - uv * gx) / g
    du_dy = ((e[..., 1:2] * uvc).sum(1) - uv * gy) / g
    size = float(s.mips[0].shape[0])
    rho = torch.maximum((du_dx * size).square().sum(1),
                        (du_dy * size).square().sum(1))
    mip = 0.5 * torch.log2(torch.clamp_min(rho, 1e-12))
    level = torch.round(torch.clamp(mip, 0.0, float(len(s.mips) - 1))).long()
    texel = sample_bilinear(s.mips, uv, level)
    base = torch.tensor(s.base_color, dtype=torch.float32, device=dev)
    cf = base.expand(t.shape[0], 4)
    if mesh.color is not None:
        cf = torch.cat([cf[:, :3] * interp(mesh.color), cf[:, 3:]], dim=1)
    albedo = texel[:, :3] * cf[:, :3]
    alpha = cf[:, 3:4] * texel[:, 3:4]
    lit = pbr(world, normal, albedo, s)
    c = lit / (lit + 1.0)
    rgb = torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2)
    out = torch.tensor(s.clear_color, dtype=torch.float32,
                       device=dev).repeat(height * width, 1)
    out[pix] = torch.cat([rgb, alpha], dim=1)
    color = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
    return {"color": color.view(height, width, 4), "depth": vis.depth,
            "tri": vis.tri}
