"""Tensor twins of the render pipeline's NamedTuples.

Port of trident_tpu/render/types.py: the same names and fields, holding
torch tensors where the JAX package holds jax arrays (pytrees become plain
NamedTuples). `from_numpy` turns any of the JAX package's NamedTuples
(read as numpy with np.asarray) into the port's twin on a device, so one
identical input can feed both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


class GeometryBuffers(NamedTuple):
    positions: Tensor     # (V,3) f32
    normals: Tensor       # (V,3) f32
    tangents: Tensor      # (V,3) f32
    bitangents: Tensor    # (V,3) f32
    colors: Tensor        # (V,3) f32
    uvs: Tensor           # (V,2) f32
    bone_indices: Tensor  # (V,4) i32 (-1 = none)
    bone_weights: Tensor  # (V,4) f32
    attr_table: Tensor    # (V,12) f32 packed pos(3) nrm(3) uv(2) col(3) pad


class DrawPlan(NamedTuple):
    """Expanded (instanced) geometry index arrays; padded triangles point
    at vertex 0 of draw 0 with tri_valid False."""

    vtx_src: Tensor      # (TV,) i32 — gather index into GeometryBuffers
    vtx_draw: Tensor     # (TV,) i32 — draw id per expanded vertex
    tri_vtx: Tensor      # (TT,3) i32 — expanded-vertex ids per triangle
    tri_valid: Tensor    # (TT,) bool
    num_draws: int


class DrawParams(NamedTuple):
    """Per-draw state, batched over D draws. xform_a/xform_b pack the model
    matrix + UV transform into two rows (model[0:12] | model[12:16],
    uv_scale, uv_offset, tiling, pad)."""

    model: Tensor          # (D,4,4) f32
    xform_a: Tensor        # (D,12) f32
    xform_b: Tensor        # (D,12) f32
    tint: Tensor           # (D,4) f32
    uv_scale: Tensor       # (D,2) f32
    uv_offset: Tensor      # (D,2) f32
    tiling: Tensor         # (D,) f32
    texture_slot: Tensor   # (D,) i32
    material_index: Tensor  # (D,) i32
    bone_offset: Tensor    # (D,) i32 — -1 = unskinned
    bone_count: Tensor     # (D,) i32


class CameraParams(NamedTuple):
    view: Tensor          # (4,4) f32
    proj: Tensor          # (4,4) f32
    position: Tensor      # (3,) f32


class LightParams(NamedTuple):
    ambient: Tensor            # (4,) rgb + intensity
    dir_direction: Tensor      # (3,) f32
    dir_color: Tensor          # (4,) rgb + intensity
    dir_count: Tensor          # () i32 (0 or 1)
    point_pos_range: Tensor    # (P,4) xyz + radius, P ∈ {0,2,4,8}
    point_color_intensity: Tensor  # (P,4) rgb + intensity
    point_count: Tensor        # () i32


class TextureArrays(NamedTuple):
    """Per-slot mip pyramids of 2×2 texel quads in ONE flat table (layout:
    render/textures.py). quads holds the JAX package's uint32 RGBA8 words
    as int32 with the same bits."""

    quads: Tensor              # (N,4) i32 (u32 bits) RGBA8
    sizes: Tensor              # (S,4) i32: w, h, flat base >> 8, pow2 edge
    max_level: Tensor          # () i32 — log2(max slot edge)


class GBuffer(NamedTuple):
    """Visibility-pass output: per-pixel winner triangle + depth."""

    tri_id: Tensor        # (H,W) i32 — -1 = background
    depth: Tensor         # (H,W) f32 — ndc z in [0,1]
    aux: Optional[Tensor] = None  # (2,) i32 [truncated pairs, dropped chunks]


class SkyboxCube(NamedTuple):
    """The cube map drawn where no triangle covers a pixel."""

    faces: Tensor         # (6, E, E, 3) f32 — +x, −x, +y, −y, +z, −z
    valid: Tensor         # () bool — False → clear color


class AiBlend(NamedTuple):
    """The display-space mix with the last interpolated AI frame."""

    image: Tensor         # (H,W,3) f32 — the AI frame, at display size
    blend: Tensor         # () f32 — 0 disables


class ShadowParams(NamedTuple):
    """Directional-light shadow map (the two-pass render graph)."""

    depth: Tensor         # (S,S) f32 light-space depth map
    light_vp: Tensor      # (4,4) f32 light view-projection
    enabled: Tensor       # () bool
    bias: Tensor          # () f32 depth bias


class FrameOutput(NamedTuple):
    color: Tensor         # (H,W,4) uint8
    depth: Tensor         # (H,W) f32
    tri_id: Tensor        # (H,W) i32
    aux: Optional[Tensor] = None  # (2,) i32 raster drop counters
    shadow_aux: Optional[Tensor] = None  # (2,) i32 the light pass's (the
                                         # JAX package drops them)
    history: Optional[Tensor] = None  # (h,w,12) uint8 upscaler output
                                      # blocks: the next frame's warp
                                      # history (ai_upscale only)
    view_proj: Optional[Tensor] = None  # (4,4) f32 the camera's proj @
                                        # view: with history, the next
                                        # frame's `prev` (ai_upscale only)


def _twins() -> dict:
    from trident_tpu_torch.ops.corner import CornerCols, CornerStageOut
    from trident_tpu_torch.ops.vertex import SetupCols, TriangleSetup

    return {cls.__name__: cls for cls in (
        GeometryBuffers, DrawPlan, DrawParams, CameraParams, LightParams,
        TextureArrays, GBuffer, SkyboxCube, AiBlend, ShadowParams,
        FrameOutput,
        TriangleSetup,
        SetupCols, CornerCols, CornerStageOut)}


def _to_tensor(value, device) -> Tensor:
    a = np.array(value)                  # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)             # same bits; torch's u32 support is thin
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def _convert(v, device):
    if v is None or isinstance(v, (int, bool)):
        return v
    if isinstance(v, tuple):
        return from_numpy(v, device)
    return _to_tensor(v, device)


def from_numpy(nt, device):
    """The port's twin of `nt` — one of the JAX package's NamedTuples (or
    any NamedTuple with the same class name and fields) — with every array
    field read through np.asarray and placed on `device`. Fields match by
    name; a source field the twin lacks must be None (e.g. the vertex
    colors the ported slice has no use for). Python ints
    (DrawPlan.num_draws) and None stay as they are; a plain tuple
    converts element by element."""
    twin = _twins().get(type(nt).__name__)
    if twin is None:
        return tuple(_convert(v, device) for v in nt)
    src = nt._asdict()
    extra = [k for k in src if k not in twin._fields and src[k] is not None]
    if extra:
        raise ValueError(f"{twin.__name__} has no field(s) {extra}")
    return twin(**{k: _convert(src[k], device) for k in twin._fields
                   if k in src})
