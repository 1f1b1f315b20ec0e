"""Per-frame draw gathering: ECS registry → packed draw tensors.

Port of trident_tpu/render/frame.py. The index expansion (which entity
instances which mesh) is cached by scene topology in DrawPlanCache; per
frame only the transforms and shading rows are packed on the host and
moved to the device. Counts are padded to power-of-two buckets exactly as
the reference pads them, so triangle ids agree between the two packages.
Skinned draws (AnimationComponent bone palettes) are not part of the
ported slice and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch.ecs.components import (
    AnimationComponent,
    MeshComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.geometry.mesh import GeometryCache, PackedGeometry
from trident_tpu_torch import resolve_device
from trident_tpu_torch.mathx.transforms import compose_trs
from trident_tpu_torch.render.types import DrawParams, DrawPlan, GeometryBuffers


@dataclass
class DrawRecord:
    """One mesh draw (host-side intermediate)."""

    entity: int
    mesh_index: int
    model: np.ndarray            # (4,4)
    tint: np.ndarray             # (4,)
    uv_scale: np.ndarray         # (2,)
    uv_offset: np.ndarray        # (2,)
    tiling: float
    texture_slot: int
    material_index: int


def gather_mesh_draws(registry: Registry,
                      cache: GeometryCache) -> List[DrawRecord]:
    """One DrawRecord per visible mesh entity. The model matrices are
    composed in one batched compose_trs call over all drawn entities
    (bit-equal to composing each alone), which keeps the host's per-entity
    cost to the component lookups."""
    drawn = []
    for entity, (transform, mesh) in registry.view(TransformComponent,
                                                   MeshComponent):
        if (not mesh.visible or mesh.mesh_index < 0
                or mesh.mesh_index >= len(cache.meshes)):
            continue
        anim = registry.try_get(entity, AnimationComponent)
        if anim is not None and anim.bone_matrices is not None:
            raise NotImplementedError(
                "skinned draws are not ported to trident_tpu_torch yet")
        drawn.append((entity, transform, mesh))
    if not drawn:
        return []
    models = compose_trs(*(np.stack([np.asarray(getattr(t, f), np.float32)
                                     for _e, t, _m in drawn])
                           for f in ("position", "rotation", "scale")))
    records: List[DrawRecord] = []
    for (entity, _transform, mesh), model in zip(drawn, models):
        material_index = (mesh.material_index
                          if 0 <= mesh.material_index < len(cache.materials)
                          else 0)
        texture_slot = cache.materials[material_index].texture_slot
        uv_scale = np.ones(2, np.float32)
        uv_offset = np.zeros(2, np.float32)
        tiling = 1.0
        tex = registry.try_get(entity, TextureComponent)
        if tex is not None:
            texture_slot = tex.slot
            uv_scale = np.asarray(tex.uv_scale, np.float32)
            uv_offset = np.asarray(tex.uv_offset, np.float32)
            tiling = float(tex.tiling)
        records.append(DrawRecord(
            entity=entity, mesh_index=mesh.mesh_index, model=model,
            tint=np.asarray(mesh.tint, np.float32), uv_scale=uv_scale,
            uv_offset=uv_offset, tiling=tiling, texture_slot=texture_slot,
            material_index=material_index))
    return records


def _bucket(n: int, minimum: int = 16) -> int:
    if n <= 0:
        return minimum
    return max(minimum, 1 << (n - 1).bit_length())


class DrawPlanCache:
    """Caches the expanded index tensors keyed by (geometry version, mesh
    indices drawn), plus the corner table and the uniform-instancing
    layout: draw_stride > 0 when every draw is one mesh, so draw d owns
    triangles [d·stride, (d+1)·stride) (ops/corner.py broadcast path)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._key: Optional[tuple] = None
        self._plan: Optional[DrawPlan] = None
        self._tri_draw: Optional[torch.Tensor] = None
        self._corner_t: Optional[torch.Tensor] = None
        self.draw_stride = 0
        self.real_draws = 0

    def plan(self, packed: PackedGeometry, records: List[DrawRecord],
             geometry_version: int) -> Tuple[DrawPlan, torch.Tensor]:
        key = (geometry_version, tuple(r.mesh_index for r in records))
        if key == self._key and self._plan is not None:
            return self._plan, self._tri_draw
        plan, tri_draw = build_draw_plan(packed, records, self.device)
        self._key, self._plan, self._tri_draw = key, plan, tri_draw
        self._corner_t = None
        tri_counts = {packed.draw_infos[r.mesh_index].index_count // 3
                      for r in records}
        if records and len(tri_counts) == 1:
            self.draw_stride = tri_counts.pop()
            self.real_draws = len(records)
        else:
            self.draw_stride = 0
            self.real_draws = 0
        return plan, tri_draw

    def corner_table(self, packed: PackedGeometry) -> torch.Tensor:
        """(36, T) planar corner table for the cached plan, built once per
        topology on the host and kept on the device."""
        if self._corner_t is None:
            from trident_tpu_torch.ops.corner import build_corner_table

            attr = np.concatenate(
                [packed.positions, packed.normals, packed.uvs, packed.colors,
                 np.zeros((packed.positions.shape[0], 1), np.float32)],
                axis=1)
            self._corner_t = torch.from_numpy(build_corner_table(
                attr, self._plan.vtx_src.cpu().numpy(),
                self._plan.tri_vtx.cpu().numpy())).to(self.device)
        return self._corner_t


def build_draw_plan(packed: PackedGeometry, records: List[DrawRecord],
                    device=None) -> Tuple[DrawPlan, torch.Tensor]:
    """Expand instanced draws into flat gather tensors on `device`.
    Returns (DrawPlan, tri_draw (TT,) i32 — draw id per triangle)."""
    vtx_src_parts: List[np.ndarray] = []
    vtx_draw_parts: List[np.ndarray] = []
    tri_parts: List[np.ndarray] = []
    tri_draw_parts: List[np.ndarray] = []
    v_cursor = 0
    for d, rec in enumerate(records):
        info = packed.draw_infos[rec.mesh_index]
        mesh_indices = packed.indices[info.first_index:
                                      info.first_index + info.index_count]
        vcount = int(mesh_indices.max()) + 1 if info.index_count else 0
        vtx_src_parts.append(np.arange(info.base_vertex,
                                       info.base_vertex + vcount,
                                       dtype=np.int32))
        vtx_draw_parts.append(np.full(vcount, d, np.int32))
        tri = mesh_indices.reshape(-1, 3).astype(np.int32) + v_cursor
        tri_parts.append(tri)
        tri_draw_parts.append(np.full(tri.shape[0], d, np.int32))
        v_cursor += vcount

    def cat(parts, shape):
        return np.concatenate(parts) if parts else np.zeros(shape, np.int32)

    vtx_src = cat(vtx_src_parts, (0,))
    vtx_draw = cat(vtx_draw_parts, (0,))
    tri_vtx = cat(tri_parts, (0, 3))
    tri_draw = cat(tri_draw_parts, (0,))

    tv = _bucket(len(vtx_src))
    tt = _bucket(tri_vtx.shape[0])
    n_draws = _bucket(len(records), minimum=4)

    def pad(a, n, dtype=np.int32):
        out = np.zeros((n, *a.shape[1:]), dtype)
        out[: a.shape[0]] = a
        return out

    dev = resolve_device(device)
    tri_valid = np.zeros(tt, bool)
    tri_valid[: tri_vtx.shape[0]] = True
    plan = DrawPlan(
        vtx_src=torch.from_numpy(pad(vtx_src, tv)).to(dev),
        vtx_draw=torch.from_numpy(pad(vtx_draw, tv)).to(dev),
        tri_vtx=torch.from_numpy(pad(tri_vtx, tt)).to(dev),
        tri_valid=torch.from_numpy(tri_valid).to(dev),
        num_draws=n_draws,
    )
    return plan, torch.from_numpy(pad(tri_draw, tt)).to(dev)


def build_draw_params(records: List[DrawRecord], num_draws: int,
                      material_table: Optional[np.ndarray] = None,
                      device=None) -> Tuple[DrawParams, torch.Tensor]:
    """Pack per-draw state and the shade table on `device`.

    Returns (DrawParams, shade_table (D,8) f32). A shade row is: color
    factor rgba (= material base color × tint), metallic, roughness,
    ambient strength, texture slot (as f32)."""
    d = num_draws
    model = np.tile(np.eye(4, dtype=np.float32), (d, 1, 1))
    tint = np.ones((d, 4), np.float32)
    uv_scale = np.ones((d, 2), np.float32)
    uv_offset = np.zeros((d, 2), np.float32)
    tiling = np.ones(d, np.float32)
    texture_slot = np.zeros(d, np.int32)
    material_index = np.zeros(d, np.int32)

    shade = np.zeros((d, 8), np.float32)
    shade[:, 0:4] = 1.0
    shade[:, 5] = 1.0  # roughness
    shade[:, 6] = 1.0  # ambient strength

    for i, rec in enumerate(records[:d]):
        model[i] = rec.model
        tint[i] = rec.tint
        if (material_table is not None
                and 0 <= rec.material_index < material_table.shape[0]):
            mat = material_table[rec.material_index]
            shade[i, 0:4] = mat[0:4] * rec.tint
            shade[i, 4] = mat[4]   # metallic
            shade[i, 5] = mat[5]   # roughness
            shade[i, 6] = mat[6]   # ambient strength
        else:
            shade[i, 0:4] = rec.tint
        shade[i, 7] = float(rec.texture_slot)
        uv_scale[i] = rec.uv_scale
        uv_offset[i] = rec.uv_offset
        tiling[i] = rec.tiling
        texture_slot[i] = rec.texture_slot
        material_index[i] = rec.material_index

    model_flat = model.reshape(d, 16)
    xform_a = model_flat[:, :12].copy()
    xform_b = np.concatenate(
        [model_flat[:, 12:16], uv_scale, uv_offset, tiling[:, None],
         np.zeros((d, 3), np.float32)], axis=1)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    params = DrawParams(
        model=t(model), xform_a=t(xform_a), xform_b=t(xform_b), tint=t(tint),
        uv_scale=t(uv_scale), uv_offset=t(uv_offset), tiling=t(tiling),
        texture_slot=t(texture_slot), material_index=t(material_index),
        bone_offset=t(np.full(d, -1, np.int32)),
        bone_count=t(np.zeros(d, np.int32)),
    )
    return params, t(shade)


def geometry_to_device(packed: PackedGeometry, device=None) -> GeometryBuffers:
    dev = resolve_device(device)
    v = packed.positions.shape[0]
    attr_table = np.concatenate(
        [packed.positions, packed.normals, packed.uvs, packed.colors,
         np.zeros((v, 1), np.float32)], axis=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GeometryBuffers(
        positions=t(packed.positions), normals=t(packed.normals),
        tangents=t(packed.tangents), bitangents=t(packed.bitangents),
        colors=t(packed.colors), uvs=t(packed.uvs),
        bone_indices=t(packed.bone_indices),
        bone_weights=t(packed.bone_weights), attr_table=t(attr_table))
