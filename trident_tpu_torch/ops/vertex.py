"""Triangle setup: homogeneous edge functions, winding, bbox, validity.

Port of trident_tpu/ops/vertex.py (the rigid forward slice: the planar
setup numerics shared by every geometry path, and the indexed
triangle_setup kept for the oracle and the tests). Skinning and the
indexed vertex stage are not ported; the frame runs the corner-major path
(ops/corner.py).

Numerics note (from the reference): depth MUST stay the per-pixel rational
zi/wi, evaluated with the association (e0·z0 + e1·z1) + e2·z2 — the
affine Σ e_k·(z_k/det) form is not self-normalizing and loses subpixel
triangles at far ZO depths. The raster kernels and the oracle keep it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


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
    """Edge functions in pixel space from clip coords: `clip` is (V,4) with
    `tri_vtx` (T,3) indices, or pre-gathered (T,3,4) with tri_vtx None.
    The viewport transform folds into the homogeneous coords
    (sx = (x + w)·W/2, sy = (y + w)·H/2) so edges evaluate at pixels."""
    c = clip if tri_vtx is None else clip[tri_vtx.long()]
    t = c.shape[0]
    ct = c.reshape(t, 12).T
    xs = [ct[0], ct[4], ct[8]]
    ys = [ct[1], ct[5], ct[9]]
    zs = [ct[2], ct[6], ct[10]]
    ws = [ct[3], ct[7], ct[11]]
    sx = [(x + w) * (0.5 * width) for x, w in zip(xs, ws)]
    sy = [(y + w) * (0.5 * height) for y, w in zip(ys, ws)]
    return planar_setup_cols(sx, sy, ws, zs, tri_valid, width, height)[0]
