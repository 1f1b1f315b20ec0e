"""The 2× upscaled frame hands out the half-size colour its net read
(FrameOutput.net_color), on the CPU: the net run again on that colour and
the frame's temporal input gives the frame's blocks and display colour
bit for bit; frames that do not upscale carry none.

No JAX here: the scenes are the port's own (tools_dev/scenes.py)."""

import pytest
import torch

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.ops.deferred import pack_rgba8
from trident_tpu_torch.render.renderer import render_frame
from trident_tpu_torch.tools_dev import scenes

SIZE = 64


def upscaled_field(ai: bool = True):
    """The 3×3 sphere field at SIZE², rendered at half size and rebuilt by
    the shipped net when `ai`."""
    r, reg = scenes.build_bench_scene(3, "cpu", ai=ai)
    r.set_viewport(0, SIZE, SIZE)
    return r, reg


def rerun_net(r, inp: dict, out):
    """(RGBA8 display colour, uint8 blocks) of the net run again on the
    frame's net_color, with the temporal input of `inp` (render_frame's
    arguments the frame was drawn from) at the frame's own depth."""
    net, knobs = inp["upscale_params"], inp["knobs"]
    depth = out.depth[::2, ::2]
    temporal = up.temporal_from_prev(net, inp["prev"], depth, inp["camera"],
                                     SIZE, SIZE, windowed=knobs.warp_mxu)
    rgb, blocks = up.apply_upscaler_v2(net, out.net_color, temporal,
                                       depth=depth, dtype=knobs.upscale_dtype,
                                       d2s_mode=knobs.d2s_mode)
    frame = torch.cat([rgb, out.color[..., 3:4].float() / 255.0], dim=-1)
    return pack_rgba8(torch.clamp(frame, 0.0, 1.0)), up.blocks_to_u8(blocks)


def test_the_net_run_on_net_color_gives_the_frames_blocks():
    r, reg = upscaled_field()
    for k in range(3):
        scenes.rotate(reg, k)
        inp = r.frame_inputs()
        assert (inp["prev"] is None) == (k == 0)
        out = r.render_viewport()
        assert out.net_color.shape == (SIZE // 2, SIZE // 2, 3)
        assert out.net_color.dtype == torch.float32
        color, blocks = rerun_net(r, inp, out)
        assert torch.equal(blocks, out.history), k
        assert torch.equal(color[..., :3], out.color[..., :3]), k


def test_net_color_is_the_half_size_render():
    """render_frame's upscaled frame, called directly, holds the same
    fields as the Renderer's, and its net_color, quantized, is the frame
    the same scene renders at half the size without the upscaler."""
    r, reg = upscaled_field()
    half, half_reg = upscaled_field(ai=False)
    half.set_viewport(0, SIZE // 2, SIZE // 2)
    for rr, rg in ((r, reg), (half, half_reg)):
        scenes.rotate(rg, 1)
        rr.render_viewport()
        scenes.rotate(rg, 2)
    inp = r.frame_inputs()
    direct = render_frame(**inp)
    out = r.render_viewport()
    for name in out._fields:
        a, b = getattr(out, name), getattr(direct, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    want = half.render_viewport().color[..., :3]
    assert torch.equal(pack_rgba8(torch.clamp(out.net_color, 0.0, 1.0)),
                       want)


@pytest.mark.parametrize("ai", [False, True])
def test_only_an_upscaled_frame_carries_net_color(ai):
    r, reg = upscaled_field(ai)
    out = r.render_viewport()
    assert (out.net_color is not None) == ai
    assert (out.history is not None) == ai
