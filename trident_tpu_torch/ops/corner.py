"""Corner-major geometry path: planar triangle setup from a static table.

Port of trident_tpu/ops/corner.py. The expanded corner table (36, T) —
per corner pos(3) nrm(3) uv(2) col(3) pad — is built once per draw-plan
topology; per frame the only per-triangle lookup is the (D, 48) draw-row
table, either gathered by tri_draw or, for uniform instancing (every draw
one mesh, `draw_stride` > 0), broadcast with a reshape:

    draw_row = [ (P·V·M row0+row3)·W/2 | (row1+row3)·H/2 | row3 | row2 |
                 cof(M) | uv_scale·tiling | uv_offset | pad | shading consts ]

With `vertex_colors` the corner stage also hands on the corners' colours
(rows 12k+8 .. 12k+10 of the table), which the resolve records carry as
three more planes (ops/planes.py RR_COL); without it they are never read.

indexed_corner_stage is the same output for the indexed path that skinned
frames take (trident_tpu/render/renderer.py:284-297): one (T, 3, 16)
gather of the vertex stage's packed rows feeds the setup and the corner
attributes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trident_tpu_torch.ops.vertex import (
    SetupCols,
    TriangleSetup,
    _cofactor3,
    planar_setup_cols,
    triangle_setup_cols,
)
from trident_tpu_torch.render.types import CameraParams, DrawParams

Tensor = torch.Tensor

DRAW_ROW = 48        # 29 transform/normal/uv floats + 12 shading consts


def build_corner_table(attr_table: np.ndarray, vtx_src: np.ndarray,
                       tri_vtx: np.ndarray) -> np.ndarray:
    """(36, T) f32 planar corner table (host-side, once per topology)."""
    src_corner = np.asarray(vtx_src)[np.asarray(tri_vtx)]       # (T,3)
    corners = np.asarray(attr_table)[src_corner]                # (T,3,12)
    t = corners.shape[0]
    return np.ascontiguousarray(corners.reshape(t, 36).T.astype(np.float32))


def build_draw_rows(params: DrawParams, camera: CameraParams, width: int,
                    height: int, draw_consts: Optional[Tensor] = None) -> Tensor:
    """(D, 48) per-draw constant rows. `draw_consts` (D,12 — shade row +
    texture row) rides in columns 32:44 for the resolve records."""
    d = params.xform_a.shape[0]
    model = torch.cat([params.xform_a, params.xform_b[:, 0:4]],
                      dim=-1).reshape(d, 4, 4)
    vp = camera.proj @ camera.view
    mvp = torch.einsum("ij,djk->dik", vp, model)                # (D,4,4)
    row_sx = (mvp[:, 0, :] + mvp[:, 3, :]) * (0.5 * width)
    row_sy = (mvp[:, 1, :] + mvp[:, 3, :]) * (0.5 * height)
    row_w = mvp[:, 3, :]
    row_z = mvp[:, 2, :]
    cof = _cofactor3(model[:, :3, :3]).reshape(d, 9)
    uv_scale = params.xform_b[:, 4:6] * params.xform_b[:, 8:9]
    uv_offset = params.xform_b[:, 6:8]
    zeros = params.xform_a.new_zeros
    consts = zeros((d, 12)) if draw_consts is None else draw_consts
    return torch.cat([row_sx, row_sy, row_w, row_z, cof, uv_scale, uv_offset,
                      zeros((d, 3)), consts, zeros((d, DRAW_ROW - 44))],
                     dim=1)


class CornerCols(NamedTuple):
    """Planar corner-stage outputs: nrm[3k+c] is corner k's world normal
    component c, uv[2k+j] its atlas UV j, consts[j] shading const j."""

    setup: SetupCols
    nrm: tuple                 # 9 (T,) world-normal columns
    uv: tuple                  # 6 (T,) atlas-UV columns
    consts: tuple              # 12 (T,) shading-const columns
    col: Optional[tuple] = None  # 9 (T,) vertex-colour columns (col[3k+c]
                                 # corner k's channel c), or None


class CornerStageOut(NamedTuple):
    setup: TriangleSetup
    cols: CornerCols


def corner_stage(corner_t: Tensor, draw_rows: Tensor, tri_draw: Tensor,
                 tri_valid: Tensor, width: int, height: int,
                 draw_stride: int = 0, real_draws: int = 0,
                 vertex_colors: bool = False) -> CornerStageOut:
    """Planar triangle setup + world corner attributes from the corner
    table (with `vertex_colors`, the corners' colours too:
    trident_tpu/ops/corner.py:174-188). `draw_stride` > 0 declares the uniform layout (draw d owns
    triangles [d·stride, (d+1)·stride) for d < real_draws, the rest is
    padding): the draw-row lookup becomes a broadcast instead of the
    (T,48) tri_draw gather."""
    t = corner_t.shape[1]
    if draw_stride > 0:
        pad = t - real_draws * draw_stride
        if pad < 0:
            raise ValueError(
                f"draw_stride {draw_stride} x real_draws {real_draws} "
                f"exceeds the corner table's {t} triangles")
        used_t = draw_rows[:real_draws].T                       # (48, D)
        body = used_t[:, :, None].expand(DRAW_ROW, real_draws, draw_stride)
        xt = body.reshape(DRAW_ROW, real_draws * draw_stride)
        if pad:
            xt = torch.cat([xt, draw_rows[0:1].T.expand(DRAW_ROW, pad)], dim=1)
    else:
        xt = draw_rows[tri_draw.long()].T                       # (48, T)

    def g(j):
        return xt[j]

    sx, sy, wz, zz = [], [], [], []
    nrm_cols, uv_cols, col_cols = [], [], []
    for k in range(3):
        px, py, pz = corner_t[12 * k], corner_t[12 * k + 1], corner_t[12 * k + 2]
        sx.append(g(0) * px + g(1) * py + g(2) * pz + g(3))
        sy.append(g(4) * px + g(5) * py + g(6) * pz + g(7))
        wz.append(g(8) * px + g(9) * py + g(10) * pz + g(11))
        zz.append(g(12) * px + g(13) * py + g(14) * pz + g(15))
        # world normal = cof(M)·n, renormalized
        nx0, ny0, nz0 = (corner_t[12 * k + 3], corner_t[12 * k + 4],
                         corner_t[12 * k + 5])
        nx = g(16) * nx0 + g(17) * ny0 + g(18) * nz0
        ny = g(19) * nx0 + g(20) * ny0 + g(21) * nz0
        nz = g(22) * nx0 + g(23) * ny0 + g(24) * nz0
        inv = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-16))
        nrm_cols += [nx * inv, ny * inv, nz * inv]
        uv_cols += [corner_t[12 * k + 6] * g(25) + g(27),
                    corner_t[12 * k + 7] * g(26) + g(28)]
        if vertex_colors:
            col_cols += [corner_t[12 * k + 8], corner_t[12 * k + 9],
                         corner_t[12 * k + 10]]

    setup, setup_cols = planar_setup_cols(sx, sy, wz, zz, tri_valid,
                                          width, height)
    cols = CornerCols(setup=setup_cols, nrm=tuple(nrm_cols),
                      uv=tuple(uv_cols),
                      consts=tuple(xt[32 + j] for j in range(12)),
                      col=tuple(col_cols) if vertex_colors else None)
    return CornerStageOut(setup=setup, cols=cols)


def indexed_corner_stage(packed: Tensor, tri_vtx: Tensor, tri_valid: Tensor,
                         width: int, height: int,
                         consts: Optional[Tensor] = None,
                         vertex_colors: bool = False) -> CornerStageOut:
    """The corner stage of the indexed path: the vertex stage's (TV, 16)
    packed rows (ops/vertex.py::VertexStageOut.packed) gathered once per
    triangle corner → setup from the corners' clip coordinates, the
    corners' normals and UVs (and colours with `vertex_colors`) as planar
    columns. `consts` (T, 12), the per-triangle shading consts the resolve
    records carry, or None (the plane tables take theirs from the shade
    table)."""
    corners = packed[tri_vtx.long()]                          # (T,3,16)
    setup, setup_cols = triangle_setup_cols(corners[..., 0:4], None,
                                            tri_valid, width, height)

    def cols(base, n):
        return tuple(corners[:, k, base + c] for k in range(3)
                     for c in range(n))

    return CornerStageOut(setup=setup, cols=CornerCols(
        setup=setup_cols, nrm=cols(4, 3), uv=cols(7, 2),
        consts=() if consts is None else tuple(consts.unbind(1)),
        col=cols(9, 3) if vertex_colors else None))
