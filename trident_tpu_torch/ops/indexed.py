"""The forward route's indexed geometry: vertex stage, corner gather,
triangle setup and resolve records in one call.

Skinned frames, and rigid frames drawn without a corner table, take the
indexed path (trident_tpu/render/renderer.py:284-297). Its plain version,
indexed_geometry_plain, is the composition the renderer ran before:
ops/vertex.py::vertex_stage (gathers, linear-blend skinning from the bone
palette, the world and clip transforms) → ops/corner.py::
indexed_corner_stage (a (T, 3, 16) corner gather, the triangle setup) →
ops/planes.py::build_resolve_cols_planar. On the card indexed_geometry runs
csrc/skinned_geometry.cu instead: one kernel that writes each vertex's
packed row once, one that builds each triangle's setup columns, bbox,
validity and record row from its three corners.

The kernel pair hands on what the forward route reads after the records:
the setup (its edge, z and w are strided views of one (15, T) table, whose
rows are the SetupCols) and no corner normal, UV, colour or const columns
(CornerCols' nrm, uv and consts are empty, col None). The plane-gather
routes, the light pass and the banded frame, which want other outputs,
keep calling the plain stages themselves.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from trident_tpu_torch import _build
from trident_tpu_torch._build import check_tensor as _check
from trident_tpu_torch.ops.corner import (
    CornerCols,
    CornerStageOut,
    indexed_corner_stage,
)
from trident_tpu_torch.ops.planes import (
    RR_WIDTH,
    RR_WIDTH_VCOLOR,
    build_resolve_cols_planar,
)
from trident_tpu_torch.ops.vertex import (
    SetupCols,
    TriangleSetup,
    _cofactor3,
    view_projection,
    vertex_stage,
)
from trident_tpu_torch.render.types import (
    CameraParams,
    DrawParams,
    DrawPlan,
    GeometryBuffers,
)
from trident_tpu_torch.utils.profiling import TRACER

Tensor = torch.Tensor

SETUP_ROWS = 15          # 9 edge coefficients, 3 clip z, 3 clip w


def indexed_geometry_plain(plan: DrawPlan, tri_draw: Tensor,
                           params: DrawParams, camera: CameraParams,
                           draw_consts: Tensor, geometry: GeometryBuffers,
                           palette: Optional[Tensor], *, width: int,
                           height: int, skinned: bool,
                           vertex_colors: bool = False
                           ) -> Tuple[CornerStageOut, Tensor]:
    """(corner stage output, (T, 32) or with `vertex_colors` (T, 40)
    records) of the indexed path in plain PyTorch; `draw_consts` (D, 12)
    are the records' shading consts by draw."""
    verts = vertex_stage(geometry, plan, params, camera, palette,
                         skinned=skinned)
    cs = indexed_corner_stage(verts.packed, plan.tri_vtx, plan.tri_valid,
                              width, height,
                              consts=draw_consts[tri_draw.long()],
                              vertex_colors=vertex_colors)
    return cs, build_resolve_cols_planar(cs.cols)


def setup_from_table(table: Tensor, bbox: Tensor,
                     valid: Tensor) -> Tuple[TriangleSetup, SetupCols]:
    """The setup of a (15, T) planar table (rows: e[3k + c], then z[k],
    then w[k]) as views: edge (T, 3, 3), z and w (T, 3) strided, the
    SetupCols its rows."""
    rows = tuple(table.unbind(0))
    return (TriangleSetup(edge=table[0:9].T.unflatten(1, (3, 3)),
                          z=table[9:12].T, w=table[12:15].T, bbox=bbox,
                          valid=valid),
            SetupCols(e=rows[0:9], z=rows[9:12], w=rows[12:15]))


def indexed_geometry(plan: DrawPlan, tri_draw: Tensor, params: DrawParams,
                     camera: CameraParams, draw_consts: Tensor,
                     geometry: GeometryBuffers, palette: Optional[Tensor], *,
                     width: int, height: int, skinned: bool,
                     vertex_colors: bool = False
                     ) -> Tuple[CornerStageOut, Tensor]:
    """indexed_geometry_plain's setup and records: the plain version for
    tensors on the CPU, the kernel pair (csrc/skinned_geometry.cu) for
    tensors on the card, whose corner columns are the setup's alone (the
    module note). Raises on inputs the kernels do not take."""
    dev = plan.tri_vtx.device
    if dev.type == "cpu":
        return indexed_geometry_plain(
            plan, tri_draw, params, camera, draw_consts, geometry, palette,
            width=width, height=height, skinned=skinned,
            vertex_colors=vertex_colors)
    tv, t = plan.vtx_src.shape[0], plan.tri_vtx.shape[0]
    v, d = geometry.attr_table.shape[0], params.xform_a.shape[0]
    _check("vtx_src", plan.vtx_src, torch.int32, (tv,), dev)
    _check("vtx_draw", plan.vtx_draw, torch.int32, (tv,), dev)
    _check("tri_vtx", plan.tri_vtx, torch.int32, (t, 3), dev)
    _check("tri_valid", plan.tri_valid, torch.bool, (t,), dev)
    _check("tri_draw", tri_draw, torch.int32, (t,), dev)
    _check("attr_table", geometry.attr_table, torch.float32, (v, 12), dev,
           align=True)
    _check("xform_a", params.xform_a, torch.float32, (d, 12), dev)
    _check("xform_b", params.xform_b, torch.float32, (d, 12), dev)
    _check("draw_consts", draw_consts, torch.float32, (d, 12), dev)
    n_palette = 0
    if skinned:
        _check("bone_indices", geometry.bone_indices, torch.int32, (v, 4),
               dev, align=True)
        _check("bone_weights", geometry.bone_weights, torch.float32, (v, 4),
               dev, align=True)
        _check("bone_offset", params.bone_offset, torch.int32, (d,), dev)
        _check("bone_count", params.bone_count, torch.int32, (d,), dev)
        if palette is None or palette.dim() != 3:
            raise ValueError("a skinned frame needs a (P, 4, 4) palette")
        n_palette = palette.shape[0]
        _check("palette", palette, torch.float32, (n_palette, 4, 4), dev)
    if max(tv, t) >= 2 ** 31 - 256:
        raise ValueError(f"{tv} vertices, {t} triangles: beyond the "
                         "kernels' 32-bit thread indices")

    # per frame, per draw, in PyTorch: P·V and the normals' cofactors, with
    # vertex_stage's own functions, so that they round as there
    vp = view_projection(camera).contiguous()
    model = torch.cat([params.xform_a, params.xform_b[:, 0:4]],
                      dim=-1).reshape(d, 4, 4)
    cof = _cofactor3(model[:, :3, :3]).reshape(d, 9).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    packed = torch.empty((tv, 16), **f32)
    rw = RR_WIDTH_VCOLOR if vertex_colors else RR_WIDTH
    table = torch.empty((SETUP_ROWS, t), **f32)
    bbox = torch.empty((t, 4), dtype=torch.int32, device=dev)
    valid = torch.empty((t,), dtype=torch.bool, device=dev)
    records = torch.empty((t, rw), **f32)
    ptr = ctypes.c_void_p
    vert_fn = _build.kernel("trident_skinned_vertices",
                            [ptr] * 11 + [ctypes.c_int] * 2 + [ptr]
                            + [ctypes.c_int] + [ptr] * 2)
    tri_fn = _build.kernel("trident_skinned_triangles",
                           [ptr] * 5 + [ctypes.c_int] * 4 + [ptr] * 5)
    bones = ((geometry.bone_indices.data_ptr(),
              geometry.bone_weights.data_ptr(), params.bone_offset.data_ptr(),
              params.bone_count.data_ptr(), palette.data_ptr())
             if skinned else (None,) * 5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = vert_fn(plan.vtx_src.data_ptr(), plan.vtx_draw.data_ptr(),
                      geometry.attr_table.data_ptr(), bones[0], bones[1],
                      params.xform_a.data_ptr(), params.xform_b.data_ptr(),
                      cof.data_ptr(), bones[2], bones[3], bones[4],
                      n_palette, int(skinned), vp.data_ptr(), tv,
                      packed.data_ptr(), stream)
        _build.check_launch("trident_skinned_vertices", err)
        err = tri_fn(plan.tri_vtx.data_ptr(), plan.tri_valid.data_ptr(),
                     tri_draw.data_ptr(), packed.data_ptr(),
                     draw_consts.data_ptr(), t, width, height, rw,
                     table.data_ptr(), bbox.data_ptr(), valid.data_ptr(),
                     records.data_ptr(), stream)
        _build.check_launch("trident_skinned_triangles", err)
    indexed_geometry.launches += 1
    TRACER.count("geometry.kernel")
    setup, cols = setup_from_table(table, bbox, valid)
    return (CornerStageOut(setup=setup, cols=CornerCols(
        setup=cols, nrm=(), uv=(), consts=())), records)


indexed_geometry.launches = 0
