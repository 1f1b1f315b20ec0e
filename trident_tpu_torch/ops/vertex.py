"""Vertex stage and triangle setup: skinning, world/clip transforms,
homogeneous edge functions, winding, bbox, validity.

Port of trident_tpu/ops/vertex.py: the indexed vertex stage (one gather
row per expanded vertex, linear-blend skinning from the global bone
palette, model and view-projection transforms) that skinned frames take,
and the planar setup numerics shared by every geometry path (the rigid
frame's corner-major path, ops/corner.py, calls planar_setup_cols too).
The JAX package's HIGHEST-pinned einsums are written here as explicit f32
sums in the order XLA:CPU's dot takes them (in index order for the
per-vertex products, pairwise for the clip transform), so the CPU and the
card round them alike and, without FMAs, as the JAX package does.

Numerics note (from the reference): depth MUST stay the per-pixel rational
zi/wi, evaluated with the association (e0·z0 + e1·z1) + e2·z2 — the
affine Σ e_k·(z_k/det) form is not self-normalizing and loses subpixel
triangles at far ZO depths. The raster kernels and the oracle keep it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from trident_tpu_torch.render.types import (
    CameraParams,
    DrawParams,
    DrawPlan,
    GeometryBuffers,
)

Tensor = torch.Tensor


class VertexStageOut(NamedTuple):
    clip: Tensor      # (TV,4) f32
    attrs: Tensor     # (TV,12) f32: world(3) normal(3) uv(2) color(3) pad
    packed: Tensor    # (TV,16) f32: clip(4) normal(3) uv(2) color(3) pad(4),
                      # the one row gathered per triangle corner
    world: Tensor     # (TV,3)
    normal: Tensor    # (TV,3) world-space, normalized
    uv: Tensor        # (TV,2) atlas-transformed
    color: Tensor     # (TV,3)


def _matvec(m: Tensor, v: Tensor) -> Tensor:
    """(..., R, C) · (..., C) → (..., R), each row's sum taken left to
    right from +0 (the HIGHEST-pinned einsum "vij,vj->vi": a row of −0
    products sums to +0, as in XLA's dot)."""
    out = m[..., 0] * v[..., None, 0] + 0.0
    for j in range(1, m.shape[-1]):
        out = out + m[..., j] * v[..., None, j]
    return out


def _cofactor3(m: Tensor) -> Tensor:
    """Cofactor matrix of (..., 3, 3): rows are cross products, so normals
    transform as cof(M)·n ∝ (M⁻¹)ᵀ·n without an inverse."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], dim=-2)


def _skin(positions: Tensor, normals: Tensor, bone_indices: Tensor,
          bone_weights: Tensor, palette: Tensor, bone_offset: Tensor,
          bone_count: Tensor) -> Tuple[Tensor, Tensor]:
    """Linear-blend skinning with up to 4 influences (Default.vert:60-90):
    an influence whose weight is ≤ 0 or whose index lies outside
    [0, bone_count) is skipped, palette indices are clamped into the
    palette, and a vertex of a draw with bone_count ≤ 0 passes through
    rigid. The weighted sum runs over the influences in order; the
    palette gather is (TV, 4, 4, 4), indexed with int64."""
    valid = ((bone_weights > 0.0) & (bone_indices >= 0)
             & (bone_indices < bone_count[:, None]))
    w = torch.where(valid, bone_weights, 0.0)                    # (TV,4)
    idx = torch.clamp(bone_offset[:, None].long() + bone_indices.long(), 0,
                      palette.shape[0] - 1)
    mats = palette[idx]                                          # (TV,4,4,4)
    skin = w[:, 0, None, None] * mats[:, 0] + 0.0         # sums from +0
    for b in range(1, 4):
        skin = skin + w[:, b, None, None] * mats[:, b]
    eye = torch.eye(4, dtype=positions.dtype, device=positions.device)
    skin = torch.where((bone_count <= 0)[:, None, None], eye, skin)
    pos_h = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    return _matvec(skin, pos_h)[:, :3], _matvec(skin[:, :3, :3], normals)


def vertex_stage(geometry: GeometryBuffers, plan: DrawPlan,
                 params: DrawParams, camera: CameraParams, palette: Tensor,
                 skinned: bool = True) -> VertexStageOut:
    """Transform every expanded vertex: gather → skin → model →
    view-projection (trident_tpu/ops/vertex.py:62-132). `palette` is the
    global (P, 4, 4) bone table; `skinned=False` skips the skinning (no
    palette gathers)."""
    src = plan.vtx_src.long()
    draw = plan.vtx_draw.long()
    row = geometry.attr_table[src]                                # (TV,12)
    positions, normals = row[:, 0:3], row[:, 3:6]
    uvs, colors = row[:, 6:8], row[:, 8:11]
    xa = params.xform_a[draw]                                     # (TV,12)
    xb = params.xform_b[draw]
    model = torch.cat([xa, xb[:, 0:4]], dim=-1).reshape(-1, 4, 4)
    if skinned:
        positions, normals = _skin(
            positions, normals, geometry.bone_indices[src],
            geometry.bone_weights[src], palette,
            params.bone_offset[draw], params.bone_count[draw])
    world_h = _matvec(model, torch.cat(
        [positions, torch.ones_like(positions[:, :1])], dim=-1))
    nrm = _matvec(_cofactor3(model[:, :3, :3]), normals)
    n2 = nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1] + nrm[:, 2] * nrm[:, 2]
    nrm = nrm * torch.rsqrt(torch.clamp_min(n2, 1e-16))[:, None]
    vp = _matvec(camera.proj, camera.view.T).T                    # P·V
    # the (TV,4)·(4,4)ᵀ product summed pairwise, as XLA's dot sums it
    p = [world_h[:, k, None] * vp[:, k] for k in range(4)]
    clip = (p[0] + p[1]) + (p[2] + p[3])                          # (TV,4)
    uv = uvs * xb[:, 4:6] * xb[:, 8:9] + xb[:, 6:8]
    world = world_h[:, :3]
    zeros = world.new_zeros
    attrs = torch.cat([world, nrm, uv, colors, zeros((world.shape[0], 1))],
                      dim=-1)
    packed = torch.cat([clip, nrm, uv, colors, zeros((world.shape[0], 4))],
                       dim=-1)
    return VertexStageOut(clip=clip, attrs=attrs, packed=packed, world=world,
                          normal=nrm, uv=uv, color=colors)


class TriangleSetup(NamedTuple):
    """Per-triangle raster constants for homogeneous (2DH) rasterization.

    edge: (T,3,3) — rows are edge-function coefficients (a,b,c) with
          e_i(px,py) = a*px + b*py + c in PIXEL coordinates; all e_i >= 0
          inside a front-facing triangle.
    z, w: (T,3) clip-space z and w per vertex
    bbox: (T,4) i32 — pixel (x0,y0,x1,y1), inclusive-exclusive
    valid:(T,) bool — front-facing, non-degenerate, on-screen
    """

    edge: Tensor
    z: Tensor
    w: Tensor
    bbox: Tensor
    valid: Tensor


class SetupCols(NamedTuple):
    """Planar twin of TriangleSetup's stacked tensors (same values as (T,)
    columns): e[3k+c] == edge[:, k, c]; z[k] == z[:, k]; w[k] == w[:, k]."""

    e: tuple      # 9 (T,) edge-coefficient columns
    z: tuple      # 3 (T,) clip-z columns
    w: tuple      # 3 (T,) clip-w columns


def planar_setup_cols(sx, sy, ws, zs, tri_valid: Tensor, width: int,
                      height: int) -> Tuple[TriangleSetup, SetupCols]:
    """Edge functions / winding / bbox / validity from planar per-corner
    lists (each a 3-list of (T,) tensors; sx/sy are viewport-scaled
    homogeneous coords, ws/zs clip w and z) — the single implementation of
    the raster-setup numerics (every epsilon lives here)."""
    t = ws[0].shape[0]

    def cross(j, k):  # adjugate row i = cross(vertex_j, vertex_k), planar
        return (sy[j] * ws[k] - ws[j] * sy[k],
                ws[j] * sx[k] - sx[j] * ws[k],
                sx[j] * sy[k] - sy[j] * sx[k])

    e0 = cross(1, 2)                     # e = (a,b,c) with p = (px,py,1)
    e1 = cross(2, 0)
    e2 = cross(0, 1)
    det = sx[0] * e0[0] + sy[0] * e0[1] + ws[0] * e0[2]
    # Vulkan front face: CCW in framebuffer coords → det > 0
    front = det > 1e-12

    # bbox from the NDC projection of w>0 vertices; triangles crossing
    # w<=0 get a conservative full-screen bbox
    safe_w = [torch.where(w.abs() < 1e-8, 1e-8, w) for w in ws]
    px = [s / w for s, w in zip(sx, safe_w)]
    py = [s / w for s, w in zip(sy, safe_w)]
    any_behind = (ws[0] <= 1e-6) | (ws[1] <= 1e-6) | (ws[2] <= 1e-6)

    def min3(v):
        return torch.minimum(torch.minimum(v[0], v[1]), v[2])

    def max3(v):
        return torch.maximum(torch.maximum(v[0], v[1]), v[2])

    x0 = torch.where(any_behind, 0.0, torch.floor(min3(px)))
    y0 = torch.where(any_behind, 0.0, torch.floor(min3(py)))
    x1 = torch.where(any_behind, float(width), torch.ceil(max3(px)) + 1.0)
    y1 = torch.where(any_behind, float(height), torch.ceil(max3(py)) + 1.0)
    x0 = x0.clamp(0, width).to(torch.int32)
    y0 = y0.clamp(0, height).to(torch.int32)
    x1 = x1.clamp(0, width).to(torch.int32)
    y1 = y1.clamp(0, height).to(torch.int32)
    bbox = torch.stack([x0, y0, x1, y1], dim=-1)

    on_screen = (x1 > x0) & (y1 > y0)
    valid = tri_valid & front & on_screen

    edge = torch.stack([*e0, *e1, *e2], dim=-1).reshape(t, 3, 3)
    return (TriangleSetup(edge=edge, z=torch.stack(zs, dim=-1),
                          w=torch.stack(ws, dim=-1), bbox=bbox, valid=valid),
            SetupCols(e=(*e0, *e1, *e2), z=tuple(zs), w=tuple(ws)))


def triangle_setup(clip: Tensor, tri_vtx, tri_valid: Tensor, width: int,
                   height: int) -> TriangleSetup:
    """triangle_setup_cols' stacked setup alone."""
    return triangle_setup_cols(clip, tri_vtx, tri_valid, width, height)[0]


def triangle_setup_cols(clip: Tensor, tri_vtx, tri_valid: Tensor,
                        width: int,
                        height: int) -> Tuple[TriangleSetup, SetupCols]:
    """Edge functions in pixel space from clip coords, stacked and as
    planar columns: `clip` is (V,4) with `tri_vtx` (T,3) indices, or
    pre-gathered (T,3,4) with tri_vtx None. The viewport transform folds
    into the homogeneous coords (sx = (x + w)·W/2, sy = (y + w)·H/2) so
    edges evaluate at pixels."""
    c = clip if tri_vtx is None else clip[tri_vtx.long()]
    t = c.shape[0]
    ct = c.reshape(t, 12).T
    xs = [ct[0], ct[4], ct[8]]
    ys = [ct[1], ct[5], ct[9]]
    zs = [ct[2], ct[6], ct[10]]
    ws = [ct[3], ct[7], ct[11]]
    sx = [(x + w) * (0.5 * width) for x, w in zip(xs, ws)]
    sy = [(y + w) * (0.5 * height) for y, w in zip(ys, ws)]
    return planar_setup_cols(sx, sy, ws, zs, tri_valid, width, height)
