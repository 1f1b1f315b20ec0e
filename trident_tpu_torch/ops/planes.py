"""Per-triangle interpolation planes: the forward path's resolve records
and the plane-gather path's attribute planes.

Port of trident_tpu/ops/planes.py. For homogeneous rasterization a vertex
attribute A interpolates as A(p) = (gA·p)/(g1·p) with p = (px, py, 1),
where gA = Σ_k A_k·edge_k and g1 = Σ_k edge_k are per-triangle constants
(plane_vectors, one fixed association for every table below).

Resolve records (forward shading): the JAX package builds an (RW, T)
column table and chunks it for the TPU's one-hot select; the port's table
is row-major (T, RR_WIDTH): one 128-byte line per triangle, which the
resolve kernels (ops/resolve.py) read with eight 16-byte loads at the
winner's row. records_from_reference carries a JAX column table across.

Attribute planes (forward_shading=False, ops/deferred.py::deferred_shade
gathers two rows per pixel), split into (T, 16) tables:
  A: g1(3) | gN.x(3) | gN.y(3) | gN.z(3) | gU(3) | pad
  B: gV(3) | shade row(8) | anchor_x | anchor_y | pad(3)
  C (vertex colours): gR(3) gG(3) gB(3) | pad(7)
In f32 the anchors are 0. With f16 tables each triangle is re-anchored at
its bbox corner snapped to 16 px (exact in f16) and every vector rescaled
by one per-triangle 1/max|component|: the rational forms and the UV
screen derivatives are invariant to a common scale, and the anchor bounds
the lever arm of f16's 10-bit mantissa.

Records and planes are built from the planar corner columns
(ops/corner.py::CornerCols) of either geometry path: the rigid corner
stage or the indexed one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trident_tpu_torch.ops.corner import CornerCols

# resolve-record row layout: plane g-vectors (3 rows each), then per-draw
# shading constants (shade row + texture row: w, h, base>>8, pow2 edge)
RR_G1, RR_NX, RR_NY, RR_NZ, RR_U, RR_V = 0, 3, 6, 9, 12, 15
RR_CF, RR_MET, RR_ROUGH, RR_AMB, RR_SLOT = 18, 22, 23, 24, 25
RR_TSX, RR_TSY, RR_BASE8, RR_EDGE = 26, 27, 28, 29
RR_COL = 30                       # vertex-colour planes r, g, b (3 each)
RR_WIDTH, RR_WIDTH_VCOLOR = 32, 40


def plane_vectors(cc: CornerCols) -> list:
    """The interpolation planes [g1, gN.x, gN.y, gN.z, gU, gV] (and gR, gG,
    gB with the corners' vertex colours, cc.col), each a 3-list of (T,)
    coefficient columns, with the reference's fixed association:
    g1 = (e0 + e1) + e2 and gA = (A0·e0 + A1·e1) + A2·e2 per coefficient
    (trident_tpu/ops/planes.py:63-76)."""
    e = cc.setup.e

    def plane_cols(a0, a1, a2):
        return [(a0 * e[c] + a1 * e[3 + c]) + a2 * e[6 + c] for c in range(3)]

    gs = [[(e[c] + e[3 + c]) + e[6 + c] for c in range(3)]]
    for c in range(3):                                 # nx, ny, nz
        gs.append(plane_cols(cc.nrm[c], cc.nrm[3 + c], cc.nrm[6 + c]))
    for j in range(2):                                 # u, v
        gs.append(plane_cols(cc.uv[j], cc.uv[2 + j], cc.uv[4 + j]))
    if cc.col is not None:
        for c in range(3):                             # r, g, b
            gs.append(plane_cols(cc.col[c], cc.col[3 + c], cc.col[6 + c]))
    return gs


def resolve_parts(cc: CornerCols) -> list:
    """The 30 record columns (39 with the corner stage's vertex colours,
    cc.col), each (T,): the six planes, the 12 shading consts, then the
    colour planes (trident_tpu/ops/planes.py:233-259)."""
    gs = plane_vectors(cc)
    return ([x for g in gs[:6] for x in g] + list(cc.consts)
            + [x for g in gs[6:] for x in g])


def build_resolve_cols_planar(cc: CornerCols) -> torch.Tensor:
    """(T, RR_WIDTH) row-major records (the JAX function's (RW, T) columns,
    transposed), columns RR_EDGE + 1 .. RR_WIDTH − 1 zero; with vertex
    colours (cc.col) (T, RR_WIDTH_VCOLOR), column 39 zero. Two passes over
    the table: the columns and zero pad columns stacked into the (RW, T)
    table, then one transposing copy into a contiguous row buffer (into
    the first 30 columns of a strided one, the copy is slower)."""
    parts = resolve_parts(cc)
    rw = RR_WIDTH if cc.col is None else RR_WIDTH_VCOLOR
    zero = torch.zeros_like(parts[0])
    cols = torch.stack(parts + [zero] * (rw - len(parts)), dim=0)
    return cols.T.contiguous()


def records_from_reference(cols: np.ndarray) -> torch.Tensor:
    """The JAX package's (RW, T) column table (numpy; RW = RR_WIDTH, or
    RR_WIDTH_VCOLOR with vertex colours) → the port's (T, RW) row-major
    records on the CPU."""
    cols = np.asarray(cols, dtype=np.float32)
    if cols.ndim != 2 or cols.shape[0] not in (RR_WIDTH, RR_WIDTH_VCOLOR):
        raise ValueError(f"expected an ({RR_WIDTH}, T) or "
                         f"({RR_WIDTH_VCOLOR}, T) column table, got "
                         f"{cols.shape}")
    return torch.from_numpy(np.ascontiguousarray(cols.T))


class AttributePlanes(NamedTuple):
    table_a: torch.Tensor            # (T,16) f32 or f16
    table_b: torch.Tensor            # (T,16) f32 or f16
    table_c: Optional[torch.Tensor]  # (T,16), or None (no vertex colours)


def build_planes_cols(cc: CornerCols, bbox: torch.Tensor,
                      tri_draw: torch.Tensor, shade_table: torch.Tensor,
                      f16: bool = False) -> AttributePlanes:
    """The attribute-plane tables (module note) from planar corner columns
    (trident_tpu/ops/planes.py:88-152, build_planes_corners): table_c when
    the corners carry vertex colours (cc.col). `bbox` is the setup's (T, 4)
    i32 pixel bbox, the f16 anchor's source; `shade_table` (D, 8) rides
    table_b by tri_draw. With `f16` the anchor is bbox // 16 · 16 in
    integers, each g = (gx, gy, gc + gx·ax + gy·ay) is rescaled by
    1 / max(m, 1e-30) over every vector's |components|, and the tables are
    rounded to f16 (nearest even)."""
    gs = plane_vectors(cc)
    t = gs[0][0].shape[0]
    zero = gs[0][0].new_zeros
    if f16:
        ax = (torch.div(bbox[:, 0], 16, rounding_mode="floor") * 16).float()
        ay = (torch.div(bbox[:, 1], 16, rounding_mode="floor") * 16).float()
        gs = [[g[0], g[1], (g[2] + g[0] * ax) + g[1] * ay] for g in gs]
        m = gs[0][0] * 0.0
        for g in gs:
            m = torch.maximum(m, torch.maximum(torch.maximum(
                g[0].abs(), g[1].abs()), g[2].abs()))
        s = 1.0 / torch.clamp_min(m, 1e-30)
        gs = [[x * s for x in g] for g in gs]
        store = torch.float16
    else:
        ax = ay = zero((t,))
        store = torch.float32

    def cols(vectors, n_pad):
        return [x for g in vectors for x in g] + [zero((t,))] * n_pad

    draw = shade_table[tri_draw.long()]                      # (T,8)
    table_a = torch.stack(cols(gs[:5], 1), dim=1)
    table_b = torch.cat([torch.stack(gs[5], dim=1), draw, ax[:, None],
                         ay[:, None], zero((t, 3))], dim=1)
    table_c = (torch.stack(cols(gs[6:], 7), dim=1).to(store)
               if cc.col is not None else None)
    return AttributePlanes(table_a=table_a.to(store),
                           table_b=table_b.to(store), table_c=table_c)
