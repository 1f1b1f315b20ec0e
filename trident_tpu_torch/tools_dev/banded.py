"""Helpers that hold the banded frame (parallel/framebuffer.py) against
the one-device frame: chip_smoke.py's phase 18 and tests/
test_torch_banded.py share them.

    banded_kwargs(inp)        render_frame_banded's arguments from
                              render_frame's (Renderer.frame_inputs)
    one_device_v1(inp, prev)  the one-device half-size frame upscaled by
                              the V1 path, as the banded :ai frame is
    frame_diffs(a, b)         which of colour, depth bits and ids differ
"""

from __future__ import annotations

import torch

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.ops.deferred import apply_ai_blend, pack_rgba8
from trident_tpu_torch.render.renderer import (
    _repeat2,
    _visibility_and_shade,
    frame_geometry,
)


def banded_kwargs(inp: dict, geometry=None) -> dict:
    """render_frame_banded's keyword arguments (all but the devices) from
    render_frame's `inp`: the uniform-instancing statics dropped (the
    banded geometry gathers its draw rows); given `geometry` (the device
    GeometryBuffers) the corner table is dropped, so a rigid frame takes
    the indexed path."""
    kw = {k: v for k, v in inp.items()
          if k not in ("draw_stride", "real_draws")}
    if geometry is not None:
        kw["corner_t"], kw["geometry"] = None, geometry
    return kw


def one_device_v1(inp: dict, prev=None):
    """(RGBA8 frame, depth) of the one-device forward frame of `inp` (an
    :ai frame's inputs: half size, upscale_params set; no bloom, no
    supersampling) with the V1 upscaler in place of render_frame's V2:
    the half-size frame through the one-device visibility and shading,
    then apply_upscaler on temporal_from_prev(prev), alpha, depth
    repeated 2×2, the AI blend and the clamp — what the banded :ai frame
    computes, on one device."""
    if inp.get("bloom") or inp.get("supersample", 1) != 1:
        raise ValueError("one_device_v1 takes frames without bloom or SSAA")
    w, h, net = inp["width"], inp["height"], inp["upscale_params"]
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"],
        vertex_colors=inp["vertex_colors"])
    frame, gbuf = _visibility_and_shade(
        cs.setup, cs.cols.setup, records, inp["textures"], inp["camera"],
        inp["lights"], width=w, height=h, clear_color=inp["clear_color"],
        knobs=inp["knobs"], skybox=inp["skybox"], sampling=inp["sampling"],
        shader_fn=inp["shader_fn"])
    temporal = up.temporal_from_prev(net, prev, gbuf.depth, inp["camera"],
                                     2 * w, 2 * h)
    rgb = up.apply_upscaler(net, frame[..., :3], temporal, depth=gbuf.depth)
    out = torch.cat([rgb, _repeat2(frame[..., 3:4])], dim=-1)
    out = torch.clamp(apply_ai_blend(out, inp["ai"]), 0.0, 1.0)
    return pack_rgba8(out), _repeat2(gbuf.depth)


def frame_diffs(a, b) -> list:
    """The fields of FrameOutputs a and b that differ: colour, depth (by
    bits) and ids."""
    out = []
    if not torch.equal(a.color, b.color):
        out.append("color")
    if not torch.equal(a.depth.view(torch.int32), b.depth.view(torch.int32)):
        out.append("depth")
    if not torch.equal(a.tri_id, b.tri_id):
        out.append("tri_id")
    return out
