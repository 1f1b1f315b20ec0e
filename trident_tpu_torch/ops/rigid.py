"""The forward route's rigid geometry: draw rows, corner stage, triangle
setup and resolve records in one call.

Rigid frames drawn from a corner table take the corner path
(trident_tpu/render/renderer.py:271-283). Its plain version,
rigid_geometry_plain, is the composition the renderer ran before:
ops/corner.py::build_draw_rows → corner_stage (its setup through
ops/vertex.py::planar_setup_cols) → ops/planes.py::
build_resolve_cols_planar. On the card rigid_geometry runs
csrc/rigid_geometry.cu instead: one kernel that reads each triangle's
corner-table column and draw row and writes its setup columns, bbox,
validity and record row. The draw rows stay in PyTorch on both paths: a few
per-draw rows of cuBLAS products (P·V·M, the normal cofactors), whose
rounding the kernel does not copy; it reads them through a pointer.

The kernel hands on what the forward route reads after the records, as the
skinned pair does (ops/indexed.py): the setup (its edge, z and w strided
views of one (15, T) table, whose rows are the SetupCols) and no corner
normal, UV, colour or const columns. The plane-gather routes, the light pass,
the banded frame and the profile stops, which want other outputs, keep
calling the plain stages themselves.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from trident_tpu_torch import _build
from trident_tpu_torch._build import check_tensor as _check
from trident_tpu_torch.ops.corner import (
    DRAW_ROW,
    CornerCols,
    CornerStageOut,
    build_draw_rows,
    corner_stage,
)
from trident_tpu_torch.ops.indexed import SETUP_ROWS, setup_from_table
from trident_tpu_torch.ops.planes import (
    RR_WIDTH,
    RR_WIDTH_VCOLOR,
    build_resolve_cols_planar,
)
from trident_tpu_torch.render.types import CameraParams, DrawParams, DrawPlan

Tensor = torch.Tensor

CORNER_ROWS = 36         # the corner table's rows: 3 corners × 12


def rigid_geometry_plain(plan: DrawPlan, tri_draw: Tensor,
                         params: DrawParams, camera: CameraParams,
                         draw_consts: Tensor, corner_t: Tensor, *,
                         width: int, height: int, draw_stride: int = 0,
                         real_draws: int = 0, vertex_colors: bool = False
                         ) -> Tuple[CornerStageOut, Tensor]:
    """(corner stage output, (T, 32) or with `vertex_colors` (T, 40)
    records) of the corner path in plain PyTorch; `draw_consts` (D, 12)
    are the records' shading consts by draw, `draw_stride` / `real_draws`
    corner_stage's layout."""
    draw_rows = build_draw_rows(params, camera, width, height,
                                draw_consts=draw_consts)
    cs = corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid, width,
                      height, draw_stride=draw_stride, real_draws=real_draws,
                      vertex_colors=vertex_colors)
    return cs, build_resolve_cols_planar(cs.cols)


def rigid_geometry(plan: DrawPlan, tri_draw: Tensor, params: DrawParams,
                   camera: CameraParams, draw_consts: Tensor,
                   corner_t: Tensor, *, width: int, height: int,
                   draw_stride: int = 0, real_draws: int = 0,
                   vertex_colors: bool = False
                   ) -> Tuple[CornerStageOut, Tensor]:
    """rigid_geometry_plain's setup and records: the plain version for
    tensors on the CPU, the kernel (csrc/rigid_geometry.cu) for tensors on
    the card, whose corner columns are the setup's alone (the module
    note). Raises on inputs the kernel does not take."""
    dev = corner_t.device
    if dev.type == "cpu":
        return rigid_geometry_plain(
            plan, tri_draw, params, camera, draw_consts, corner_t,
            width=width, height=height, draw_stride=draw_stride,
            real_draws=real_draws, vertex_colors=vertex_colors)
    t = corner_t.shape[-1]
    _check("corner_t", corner_t, torch.float32, (CORNER_ROWS, t), dev)
    _check("tri_valid", plan.tri_valid, torch.bool, (t,), dev)
    _check("tri_draw", tri_draw, torch.int32, (t,), dev)
    if t >= 2 ** 31 - 256:
        raise ValueError(f"{t} triangles: beyond the kernel's 32-bit thread "
                         "indices")
    if draw_stride > 0 and real_draws * draw_stride > t:
        raise ValueError(
            f"draw_stride {draw_stride} x real_draws {real_draws} "
            f"exceeds the corner table's {t} triangles")
    draw_rows = build_draw_rows(params, camera, width, height,
                                draw_consts=draw_consts)
    d = draw_rows.shape[0]
    _check("draw_rows", draw_rows, torch.float32, (d, DRAW_ROW), dev,
           align=True)
    if d < 1 or (draw_stride > 0 and not 0 <= real_draws <= d):
        raise ValueError(f"{d} draw rows for real_draws {real_draws}: the "
                         "kernel needs row 0 and every real draw's")
    f32 = dict(dtype=torch.float32, device=dev)
    rw = RR_WIDTH_VCOLOR if vertex_colors else RR_WIDTH
    table = torch.empty((SETUP_ROWS, t), **f32)
    bbox = torch.empty((t, 4), dtype=torch.int32, device=dev)
    valid = torch.empty((t,), dtype=torch.bool, device=dev)
    records = torch.empty((t, rw), **f32)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _build.launch("trident_rigid_geometry", [ptr] * 4 + [i32] * 6 + [ptr] * 4,
                  dev, corner_t.data_ptr(), draw_rows.data_ptr(),
                  tri_draw.data_ptr(), plan.tri_valid.data_ptr(), t,
                  draw_stride, real_draws, width, height, rw,
                  table.data_ptr(), bbox.data_ptr(), valid.data_ptr(),
                  records.data_ptr())
    setup, cols = setup_from_table(table, bbox, valid)
    return (CornerStageOut(setup=setup, cols=CornerCols(
        setup=cols, nrm=(), uv=(), consts=())), records)
