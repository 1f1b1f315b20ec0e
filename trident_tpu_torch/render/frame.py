"""Per-frame draw gathering: ECS registry → packed draw tensors.

Port of trident_tpu/render/frame.py. The index expansion (which entity
instances which mesh) is cached by scene topology in DrawPlanCache; per
frame only the transforms and shading rows are packed on the host and
moved to the device. Counts are padded to power-of-two buckets exactly as
the reference pads them, so triangle ids agree between the two packages.
Sprites are textured quads drawn after the meshes (gather_sprite_batch).
A skinned draw carries its AnimationComponent's bone matrices; the frame's
global palette packs them in draw order (bone_palette_host), as the JAX
package's build_draw_params does, so palette indices agree too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch.ecs.components import (
    AnimationComponent,
    MeshComponent,
    SpriteComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.geometry.mesh import GeometryCache, PackedGeometry
from trident_tpu_torch import resolve_device
from trident_tpu_torch.mathx.transforms import compose_trs
from trident_tpu_torch.utils.profiling import TRACER
from trident_tpu_torch.render.types import (
    DrawParams,
    DrawPlan,
    GeometryBuffers,
    from_numpy,
)


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
    bone_matrices: Optional[np.ndarray] = None   # (B,4,4) or None


@dataclass(frozen=True)
class DrawBatch:
    """The frame's draws as arrays, one row per drawn entity. Iterating
    it gives the DrawRecords (tiling as f32) that record-walking callers
    take (gather_mesh_draws, scene_bounds)."""

    entity: np.ndarray           # (N,) i64
    mesh_index: np.ndarray       # (N,) i64
    model: np.ndarray            # (N,4,4) f32
    tint: np.ndarray             # (N,4) f32
    uv_scale: np.ndarray         # (N,2) f32
    uv_offset: np.ndarray        # (N,2) f32
    tiling: np.ndarray           # (N,) f32
    texture_slot: np.ndarray     # (N,) i64
    material_index: np.ndarray   # (N,) i64
    bone_matrices: np.ndarray    # (N,) object: (B,4,4) arrays or None

    def __len__(self) -> int:
        return self.entity.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield DrawRecord(
                entity=int(self.entity[i]),
                mesh_index=int(self.mesh_index[i]), model=self.model[i],
                tint=self.tint[i], uv_scale=self.uv_scale[i],
                uv_offset=self.uv_offset[i], tiling=float(self.tiling[i]),
                texture_slot=int(self.texture_slot[i]),
                material_index=int(self.material_index[i]),
                bone_matrices=self.bone_matrices[i])

    def concat(self, other: "DrawBatch") -> "DrawBatch":
        """This batch's draws, then `other`'s."""
        return DrawBatch(**{f: np.concatenate([getattr(self, f),
                                               getattr(other, f)])
                            for f in self.__dataclass_fields__})

    @staticmethod
    def from_records(records: List[DrawRecord]) -> "DrawBatch":
        """The batch holding `records` (a DrawRecord list)."""
        def col(f, dtype, shape):
            vals = [getattr(r, f) for r in records]
            return (np.asarray(vals, dtype) if vals
                    else np.zeros((0, *shape), dtype))

        return DrawBatch(
            entity=col("entity", np.int64, ()),
            mesh_index=col("mesh_index", np.int64, ()),
            model=col("model", np.float32, (4, 4)),
            tint=col("tint", np.float32, (4,)),
            uv_scale=col("uv_scale", np.float32, (2,)),
            uv_offset=col("uv_offset", np.float32, (2,)),
            tiling=col("tiling", np.float32, ()),
            texture_slot=col("texture_slot", np.int64, ()),
            material_index=col("material_index", np.int64, ()),
            bone_matrices=_objects([r.bone_matrices for r in records]))

    @property
    def skinned(self) -> bool:
        """Whether any draw carries bone matrices (the JAX Renderer's
        test: an empty (0, 4, 4) array counts)."""
        return any(b is not None for b in self.bone_matrices)


def _objects(values: list) -> np.ndarray:
    """(N,) object array holding `values` as they are (np.asarray would
    stack equal-shaped bone arrays into one block)."""
    out = np.empty(len(values), object)
    out[:] = values
    return out


def gather_draw_batch(registry: Registry,
                      cache: GeometryCache) -> DrawBatch:
    """One row per visible mesh entity, the draws of the JAX package's
    gather_mesh_draws: the per-entity work is the component lookups; the
    model matrices (one batched compose_trs, bit-equal to composing each
    alone) and the material, texture and default-value choices run over
    all draws at once in numpy."""
    rows = []
    for entity, (transform, mesh) in registry.view(TransformComponent,
                                                   MeshComponent):
        if (not mesh.visible or mesh.mesh_index < 0
                or mesh.mesh_index >= len(cache.meshes)):
            continue
        anim = registry.try_get(entity, AnimationComponent)
        rows.append((entity, transform, mesh,
                     registry.try_get(entity, TextureComponent),
                     None if anim is None else anim.bone_matrices))
    if not rows:
        return DrawBatch.from_records([])
    n = len(rows)
    material = np.array([m.material_index for _e, _t, m, _x, _b in rows],
                        np.int64)
    material = np.where((material >= 0) & (material < len(cache.materials)),
                        material, 0)
    texture_slot = np.array([m.texture_slot for m in cache.materials],
                            np.int64)[material]
    uv_scale = np.ones((n, 2), np.float32)
    uv_offset = np.zeros((n, 2), np.float32)
    tiling = np.ones(n, np.float32)
    textured = [k for k, row in enumerate(rows) if row[3] is not None]
    if textured:
        texs = [rows[k][3] for k in textured]
        texture_slot[textured] = [x.slot for x in texs]
        uv_scale[textured] = np.array([x.uv_scale for x in texs], np.float32)
        uv_offset[textured] = np.array([x.uv_offset for x in texs],
                                       np.float32)
        tiling[textured] = [float(x.tiling) for x in texs]
    return DrawBatch(
        entity=np.array([e for e, _t, _m, _x, _b in rows], np.int64),
        mesh_index=np.array([m.mesh_index for _e, _t, m, _x, _b in rows],
                            np.int64),
        model=compose_trs(*(np.array([getattr(row[1], f) for row in rows],
                                     np.float32)
                            for f in ("position", "rotation", "scale"))),
        tint=np.array([m.tint for _e, _t, m, _x, _b in rows], np.float32),
        uv_scale=uv_scale, uv_offset=uv_offset, tiling=tiling,
        texture_slot=texture_slot, material_index=material,
        bone_matrices=_objects([b for _e, _t, _m, _x, b in rows]))



def gather_mesh_draws(registry: Registry,
                      cache: GeometryCache) -> List[DrawRecord]:
    """gather_draw_batch's draws as a DrawRecord list (the JAX package's
    form)."""
    return list(gather_draw_batch(registry, cache))


def gather_sprite_batch(registry: Registry, quad_mesh_index: int,
                        time_s: float = 0.0,
                        texture_lookup=None) -> DrawBatch:
    """One row per visible sprite, drawn as the textured quad
    `quad_mesh_index` (trident_tpu/render/frame.py:81-113): the atlas
    tile's UV window (uv_scale / tiles, offset by the tile's column and
    row over tiles), the tile index advanced by ⌊time_s ·
    animation_speed⌋ when the sprite animates, sort_offset added to the
    model matrix's z translation, and a sprite with slot 0 and a
    texture_path takes `texture_lookup(path)`'s slot. The model matrices
    are one batched compose_trs, bit-equal to composing each alone."""
    rows = [(e, t, sp) for e, (t, sp) in registry.view(TransformComponent,
                                                        SpriteComponent)
            if sp.visible]
    if not rows:
        return DrawBatch.from_records([])
    n = len(rows)
    model = compose_trs(*(np.array([getattr(t, f) for _e, t, _s in rows],
                                   np.float32)
                          for f in ("position", "rotation", "scale")))
    offset = np.array([sp.sort_offset for _e, _t, sp in rows], np.float32)
    model[:, 2, 3] = np.where(offset != 0, model[:, 2, 3] + offset,
                              model[:, 2, 3])
    uv_scale = np.empty((n, 2), np.float32)
    uv_offset = np.empty((n, 2), np.float32)
    slots = np.empty(n, np.int64)
    for k, (_e, _t, sp) in enumerate(rows):
        tiles = max(int(sp.atlas_tiles), 1)
        index = int(sp.atlas_index)
        if sp.animation_speed > 0.0:
            index = (index + int(time_s * sp.animation_speed)) % (tiles * tiles)
        uv_scale[k] = np.asarray(sp.uv_scale, np.float32) / tiles
        uv_offset[k] = (np.asarray(sp.uv_offset, np.float32)
                        + np.array([index % tiles, index // tiles],
                                   np.float32) / tiles)
        slot = sp.texture_slot
        if slot == 0 and sp.texture_path and texture_lookup is not None:
            slot = texture_lookup(sp.texture_path)
        slots[k] = slot
    return DrawBatch(
        entity=np.array([e for e, _t, _s in rows], np.int64),
        mesh_index=np.full(n, quad_mesh_index, np.int64),
        model=model,
        tint=np.array([sp.tint for _e, _t, sp in rows], np.float32),
        uv_scale=uv_scale, uv_offset=uv_offset,
        tiling=np.array([float(sp.tiling) for _e, _t, sp in rows],
                        np.float32),
        texture_slot=slots, material_index=np.zeros(n, np.int64),
        bone_matrices=_objects([None] * n))


def gather_sprite_draws(registry: Registry, cache, quad_mesh_index: int,
                        time_s: float = 0.0,
                        texture_lookup=None) -> List[DrawRecord]:
    """gather_sprite_batch's draws as a DrawRecord list (the JAX package's
    form, trident_tpu/render/frame.py:81; `cache` is unused there too)."""
    return list(gather_sprite_batch(registry, quad_mesh_index, time_s,
                                    texture_lookup))


def _mesh_indices(records) -> tuple:
    """The drawn mesh of each draw of a DrawBatch or a DrawRecord list."""
    if isinstance(records, DrawBatch):
        return tuple(records.mesh_index.tolist())
    return tuple(r.mesh_index for r in records)


def _bucket(n: int, minimum: int = 16) -> int:
    if n <= 0:
        return minimum
    return max(minimum, 1 << (n - 1).bit_length())


class DrawPlanCache:
    """Caches the expanded index tensors keyed by (geometry version, mesh
    indices drawn), plus the corner table and the uniform-instancing
    layout: draw_stride > 0 when every draw is one mesh, so draw d owns
    triangles [d·stride, (d+1)·stride) (ops/corner.py broadcast path).
    `triangles` is the plan's triangle count (the Renderer's
    stats_triangles), counted once per plan."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._key: Optional[tuple] = None
        self._plan: Optional[DrawPlan] = None
        self._tri_draw: Optional[torch.Tensor] = None
        self._corner_t: Optional[torch.Tensor] = None
        # monotone rebuild counter: the idle-frame signature and the frame
        # graphs' key read it (a new plan is new tensors at new addresses)
        self.version = 0
        self.draw_stride = 0
        self.real_draws = 0
        self.triangles = 0

    def plan(self, packed: PackedGeometry, records: List[DrawRecord],
             geometry_version: int) -> Tuple[DrawPlan, torch.Tensor]:
        key = (geometry_version, _mesh_indices(records))
        if key == self._key and self._plan is not None:
            return self._plan, self._tri_draw
        plan, tri_draw = build_draw_plan(packed, records, self.device)
        TRACER.count("upload.geometry")
        self._key, self._plan, self._tri_draw = key, plan, tri_draw
        self._corner_t = None
        self.version += 1
        per_draw = [packed.draw_infos[m].index_count // 3 for m in key[1]]
        self.triangles = sum(per_draw)
        tri_counts = set(per_draw)
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
            TRACER.count("upload.geometry")
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
    for d, mesh_index in enumerate(_mesh_indices(records)):
        info = packed.draw_infos[mesh_index]
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


def _bone_layout(draws: DrawBatch, num_draws: int, max_bones: int):
    """(bone_offset (D,) i32, bone_count (D,) i32, the skinned draws' bone
    blocks in draw order): each of the first num_draws draws with a
    non-empty bone array takes its first max_bones matrices at the next
    palette offset; the others get offset −1 and count 0
    (trident_tpu/render/frame.py:293-299)."""
    d = num_draws
    bones = draws.bone_matrices[:d]
    blocks = [np.asarray(b, np.float32)[:max_bones]
              if b is not None and len(b) > 0 else None for b in bones]
    has = np.zeros(d, bool)
    has[:len(blocks)] = [b is not None for b in blocks]
    count = np.zeros(d, np.int32)
    count[:len(blocks)] = [0 if b is None else b.shape[0] for b in blocks]
    offset = np.where(has, np.cumsum(count) - count, -1).astype(np.int32)
    return offset, count, [b for b in blocks if b is not None]


def bone_palette_host(draws: DrawBatch, num_draws: int,
                      max_bones: int = 128) -> np.ndarray:
    """The frame's global bone palette (P, 4, 4) f32 (the frame bundle's
    form): the skinned draws' matrices in draw order (each capped at
    max_bones), padded with identities to P = the power-of-two bucket of
    their count, at least 1; one identity when no draw is skinned
    (render/bundle.py::zero_palette)."""
    blocks = _bone_layout(draws, num_draws, max_bones)[2]
    n = sum(b.shape[0] for b in blocks)
    palette = np.tile(np.eye(4, dtype=np.float32),
                      (_bucket(max(n, 1), minimum=1), 1, 1))
    if blocks:
        palette[:n] = np.concatenate(blocks, axis=0)
    return palette


def build_draw_params_host(draws: DrawBatch, num_draws: int,
                           material_table: Optional[np.ndarray] = None,
                           max_bones: int = 128
                           ) -> Tuple[DrawParams, np.ndarray]:
    """Pack per-draw state and the shade table as numpy (the frame
    bundle's form), all draws at once.

    Returns (DrawParams, shade_table (D,8) f32). A shade row is: color
    factor rgba (= material base color × tint), metallic, roughness,
    ambient strength, texture slot (as f32). A skinned draw's bone_offset
    and bone_count place its matrices in bone_palette_host's palette."""
    d = num_draws
    n = min(len(draws), d)
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

    model[:n] = draws.model[:n]
    tint[:n] = draws.tint[:n]
    mi = draws.material_index[:n]
    shade[:n, 0:4] = tint[:n]
    if material_table is not None:
        ok = (mi >= 0) & (mi < material_table.shape[0])
        mat = material_table[mi[ok]]
        shade[:n][ok, 0:4] = mat[:, 0:4] * tint[:n][ok]
        shade[:n][ok, 4:7] = mat[:, 4:7]  # metallic, roughness, ambient
    shade[:n, 7] = draws.texture_slot[:n]
    uv_scale[:n] = draws.uv_scale[:n]
    uv_offset[:n] = draws.uv_offset[:n]
    tiling[:n] = draws.tiling[:n]
    texture_slot[:n] = draws.texture_slot[:n]
    material_index[:n] = mi

    bone_offset, bone_count, _blocks = _bone_layout(draws, d, max_bones)
    model_flat = model.reshape(d, 16)
    xform_a = model_flat[:, :12].copy()
    xform_b = np.concatenate(
        [model_flat[:, 12:16], uv_scale, uv_offset, tiling[:, None],
         np.zeros((d, 3), np.float32)], axis=1)
    params = DrawParams(
        model=model, xform_a=xform_a, xform_b=xform_b, tint=tint,
        uv_scale=uv_scale, uv_offset=uv_offset, tiling=tiling,
        texture_slot=texture_slot, material_index=material_index,
        bone_offset=bone_offset, bone_count=bone_count,
    )
    return params, shade


def build_draw_params(records: List[DrawRecord], num_draws: int,
                      material_table: Optional[np.ndarray] = None,
                      device=None) -> Tuple[DrawParams, torch.Tensor]:
    """build_draw_params_host's (DrawParams, shade_table) for a
    DrawRecord list (the JAX package's form), on `device`."""
    params, shade = build_draw_params_host(DrawBatch.from_records(records),
                                           num_draws, material_table)
    dev = resolve_device(device)
    return from_numpy(params, dev), torch.from_numpy(shade).to(dev)


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
