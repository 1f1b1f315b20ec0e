"""Resolve records: per-triangle interpolation planes + shading constants.

Port of trident_tpu/ops/planes.py (the column-native builder of the
forward path). For homogeneous rasterization a vertex attribute A
interpolates as A(p) = (gA·p)/(g1·p) with p = (px, py, 1), where
gA = Σ_k A_k·edge_k and g1 = Σ_k edge_k are per-triangle constants. The
JAX package builds an (RW, T) column table and chunks it for the TPU's
one-hot select; the port's table is row-major (T, RR_WIDTH): one 128-byte
line per triangle, which the resolve kernels (ops/resolve.py) read with
eight 16-byte loads at the winner's row. records_from_reference carries a
JAX column table across.
"""

from __future__ import annotations

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


def resolve_parts(cc: CornerCols) -> list:
    """The 30 record columns (39 with the corner stage's vertex colours,
    cc.col), each (T,), from the corner stage's planar columns, with the
    reference's fixed association: g1 = (e0 + e1) + e2 and
    gA = (A0·e0 + A1·e1) + A2·e2 per coefficient
    (trident_tpu/ops/planes.py:191-194,253-257)."""
    e = cc.setup.e

    def plane_cols(a0, a1, a2):
        return [(a0 * e[c] + a1 * e[3 + c]) + a2 * e[6 + c] for c in range(3)]

    parts = [(e[c] + e[3 + c]) + e[6 + c] for c in range(3)]
    for c in range(3):                                 # nx, ny, nz
        parts += plane_cols(cc.nrm[c], cc.nrm[3 + c], cc.nrm[6 + c])
    for j in range(2):                                 # u, v
        parts += plane_cols(cc.uv[j], cc.uv[2 + j], cc.uv[4 + j])
    parts += list(cc.consts)
    if cc.col is not None:
        for c in range(3):                             # r, g, b
            parts += plane_cols(cc.col[c], cc.col[3 + c], cc.col[6 + c])
    return parts


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
