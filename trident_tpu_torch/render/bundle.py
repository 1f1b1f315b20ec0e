"""Per-frame input bundling (port of trident_tpu/render/bundle.py): every
host-varying value of a frame in TWO blobs, one f32 and one i32.

`pack_frame` flattens the draw transforms, shade rows, camera, lights,
light camera, AI blend, shadow bias and bone palette on the host, in the
JAX package's layout exactly (the header _HDR, the field order), so a blob
packed by either package unpacks in the other. `unpack_frame` slices the
blobs on the device back into the frame's NamedTuples. The geometry,
plan, texture and upscaler tensors are device-resident and cached by
version (render/renderer.py), so they never travel with the bundle.

Skinning is not ported: the port packs the zero-bone palette (one identity
matrix, `zero_palette()`), where the JAX layout puts the palette.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch.render.types import (
    CameraParams,
    DrawParams,
    LightParams,
)

# fixed-size header: camera(16+16+3) lights(4+3+4) light_cam(16+16+3)
# ai_blend(1) shadow_bias(1)
_CAM = 35
_LIGHTS = 11
_HDR = _CAM + _LIGHTS + _CAM + 2


class BundleShape(NamedTuple):
    """Static layout key (one captured frame graph per shape bucket)."""

    d: int      # draw bucket
    p: int      # palette bucket
    lp: int     # point-light bucket (0/2/4/8)


def zero_palette() -> np.ndarray:
    """The palette of a frame without skinned draws: the JAX package's
    one-identity bucket (build_draw_params with no bones)."""
    return np.eye(4, dtype=np.float32)[None]


def pack_frame(params: DrawParams, palette: np.ndarray, shade: np.ndarray,
               camera: CameraParams, lights: LightParams,
               light_camera: Optional[CameraParams], ai_blend: float,
               shadow_bias: float = 2e-3) -> Tuple[np.ndarray, np.ndarray,
                                                   BundleShape]:
    """Host-side: flatten every per-frame value → (f32 blob, i32 blob,
    shape). All inputs are numpy (build_draw_params_host,
    gather_lights_host and Camera.host_params produce numpy)."""
    d = shade.shape[0]
    p = palette.shape[0]
    lp = np.shape(lights.point_pos_range)[0]
    lc = light_camera if light_camera is not None else camera
    f32 = np.concatenate([
        np.ravel(params.xform_a), np.ravel(params.xform_b), np.ravel(shade),
        np.ravel(camera.view), np.ravel(camera.proj), np.ravel(camera.position),
        np.ravel(lights.ambient), np.ravel(lights.dir_direction),
        np.ravel(lights.dir_color),
        np.ravel(lc.view), np.ravel(lc.proj), np.ravel(lc.position),
        np.asarray([ai_blend, shadow_bias], np.float32),
        np.ravel(lights.point_pos_range),
        np.ravel(lights.point_color_intensity),
        np.ravel(palette),
    ]).astype(np.float32, copy=False)
    i32 = np.concatenate([
        np.ravel(params.texture_slot), np.ravel(params.bone_offset),
        np.ravel(params.bone_count),
        np.asarray([int(lights.dir_count), int(lights.point_count)]),
    ]).astype(np.int32, copy=False)
    return f32, i32, BundleShape(d, p, lp)


def blob_sizes(shape: BundleShape) -> Tuple[int, int]:
    """(f32 elements, i32 elements) of a bundle of `shape`."""
    d, p, lp = shape
    return _HDR + d * 32 + lp * 8 + p * 16, 3 * d + 2


def unpack_frame(f32: torch.Tensor, i32: torch.Tensor, shape: BundleShape):
    """Device-side: blob slices → (params, palette, shade, camera, lights,
    light_camera, ai_blend, shadow_bias) as views of the blobs, except the
    two cameras' matrices: those are copies, which start at an aligned
    address of their own as Camera.params' tensors do, so that the
    matmuls reading them take the path they take there. Fields the frame
    never reads (model, tint, uv, tiling, material) are zero placeholders,
    as in the JAX package. Raises ValueError when the blobs do not hold
    the layout of `shape`."""
    d, p, lp = shape
    n_f32, n_i32 = blob_sizes(shape)
    if f32.shape != (n_f32,) or i32.shape != (n_i32,):
        raise ValueError(
            f"frame bundle layout drift: blobs {tuple(f32.shape)} f32 and "
            f"{tuple(i32.shape)} i32, the layout of {shape} expects "
            f"({n_f32},) and ({n_i32},)")
    o = 0

    def take(n, shp, copy=False):
        nonlocal o
        v = f32[o:o + n].reshape(shp)
        o += n
        return v.clone() if copy else v

    xform_a = take(d * 12, (d, 12))
    xform_b = take(d * 12, (d, 12))
    shade = take(d * 8, (d, 8))
    cam_view = take(16, (4, 4), copy=True)
    cam_proj = take(16, (4, 4), copy=True)
    cam_pos = take(3, (3,))
    ambient = take(4, (4,))
    dir_direction = take(3, (3,))
    dir_color = take(4, (4,))
    lc_view = take(16, (4, 4), copy=True)
    lc_proj = take(16, (4, 4), copy=True)
    lc_pos = take(3, (3,))
    ai_blend = take(1, ())
    shadow_bias = take(1, ())
    point_pos_range = take(lp * 4, (lp, 4))
    point_color_intensity = take(lp * 4, (lp, 4))
    palette = take(p * 16, (p, 4, 4))
    # pack/unpack agree on ~16 field orderings by discipline alone; these
    # checks turn any one-sided layout drift into a loud error instead of
    # silently mis-sliced lights/palette (shapes are static: host-only)
    if o != n_f32:
        raise ValueError(f"frame bundle layout drift: consumed {o} of "
                         f"{n_f32} for shape {shape}")

    zero, izero = f32.new_zeros(()), i32.new_zeros(())
    params = DrawParams(
        model=zero.expand(d, 4, 4), xform_a=xform_a, xform_b=xform_b,
        tint=zero.expand(d, 4), uv_scale=zero.expand(d, 2),
        uv_offset=zero.expand(d, 2), tiling=zero.expand(d),
        texture_slot=i32[0:d], material_index=izero.expand(d),
        bone_offset=i32[d:2 * d], bone_count=i32[2 * d:3 * d])
    lights = LightParams(
        ambient=ambient, dir_direction=dir_direction, dir_color=dir_color,
        dir_count=i32[3 * d], point_pos_range=point_pos_range,
        point_color_intensity=point_color_intensity,
        point_count=i32[3 * d + 1])
    camera = CameraParams(view=cam_view, proj=cam_proj, position=cam_pos)
    light_cam = CameraParams(view=lc_view, proj=lc_proj, position=lc_pos)
    return (params, palette, shade, camera, lights, light_cam, ai_blend,
            shadow_bias)
