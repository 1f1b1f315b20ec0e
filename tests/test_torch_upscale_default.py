"""The default 2× frame against the JAX package's default 2× frame.

The JAX package runs the upscaler's convolutions in bf16 by default
(trident_tpu/ai/upscaler.py UPSCALE_DTYPE); the port runs them in f32 by
default (ops/kernel_knobs.py, KernelKnobs.upscale_dtype) and in bf16
under upscale_dtype="bf16". test_torch_frame.py holds the port against
the JAX frames with f32 forced on the JAX side; this file holds the
port's Renderer against the JAX package's default frames (bf16 convs, no
upscale_dtype override, the Pallas warp interpreted): the two chained
128² AI-upscaled frames of test_torch_frame._ai_renderer() under the
golden gate, aux [0, 0] on both sides, with the port's default knobs,
with upscale_dtype="bf16", and with each other d2s_mode (a bit-exact
relayout in both packages: the port's frames are its default frames).
Its own file, so that `--dist loadfile` gives it a worker of its own
(about a minute on the CPU; `pytest -s` prints each frame's drift).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax

from trident_tpu.ai import upscaler as jup
from trident_tpu.ai.upscaler import load_upscaler
from trident_tpu.ops import kernel_knobs as jknobs

from trident_tpu_torch.ops import kernel_knobs
from trident_tpu_torch.ops.kernel_knobs import KernelKnobs

from test_torch_frame import (
    AI_ORBIT,
    _ai_renderer,
    _assert_golden_gate,
    _jax_frame_op_by_op,
)
from test_torch_host import carry_renderer

CHECKPOINT = (pathlib.Path(__file__).resolve().parents[1] / "assets_out"
              / "upscaler_2x")


def _jax_default_frames(jr):
    """The JAX package's two AI-upscaled frames of `jr`'s scene with its
    default upscaler dtype (bf16); the camera is orbited between them."""
    params, _bc = load_upscaler(str(CHECKPOINT))
    with jknobs.overrides(upscale_v2=True, warp_mxu=True):
        assert jup.UPSCALE_DTYPE == "bf16"
        out0 = _jax_frame_op_by_op(jr, params)
        p = jr.editor_camera.params()
        vp0 = jax.numpy.matmul(p.proj, p.view,
                               precision=jax.lax.Precision.HIGHEST)
        jr.editor_camera.orbit(*AI_ORBIT)
        out1 = _jax_frame_op_by_op(jr, params, (out0.history, vp0))
    return out0, out1


@pytest.fixture(scope="module")
def jouts():
    return _jax_default_frames(_ai_renderer())


def _port_frames(kernel=None):
    """The port's two chained frames of the same scene under `kernel`."""
    tr = carry_renderer(_ai_renderer(), kernel=kernel)
    outs = [tr.render_viewport()]
    tr.editor_camera.orbit(*AI_ORBIT)
    outs.append(tr.render_viewport())
    return tr, outs


def _hold(tr, outs, jouts):
    for k, (out, jout) in enumerate(zip(outs, jouts)):
        assert out.aux.tolist() == [0, 0], k
        assert np.asarray(jout.aux).tolist() == [0, 0], k
        assert out.color.shape == (128, 128, 4), k
        frame, ref = tr.read_frame(out), np.asarray(jout.color)
        diff = np.abs(frame.astype(np.int32) - ref.astype(np.int32))
        print(f"frame {k}: {int((diff > 3).sum())} values off by > 3 LSB, "
              f"max {int(diff.max())}, mean {diff.mean():.4f}")
        _assert_golden_gate(frame, ref)


def test_default_upscaled_frames_match_jax_default(jouts):
    assert KernelKnobs().upscale_dtype == "f32"
    assert kernel_knobs.JAX_DEFAULTS["upscale_dtype"] == "bf16"
    tr, outs = _port_frames()
    assert tr.config.render.kernel is None
    _hold(tr, outs, jouts)


def test_bf16_upscaled_frames_match_jax_default(jouts):
    """upscale_dtype="bf16": the port's bf16 convs against the JAX
    default's, the same dtype on both sides."""
    tr, outs = _port_frames({"upscale_dtype": "bf16"})
    assert tr.knobs.upscale_dtype == "bf16"
    _hold(tr, outs, jouts)
    _tr32, f32 = _port_frames()
    assert not torch.equal(outs[0].color, f32[0].color)


@pytest.mark.parametrize("mode", ["pad", "xla"])
def test_d2s_mode_frames_are_the_default(mode, jouts):
    """d2s_mode: the JAX modes are one relayout of the JAX history's
    blocks, and the port's frames under the mode are its default frames
    bit for bit, in the gate of the JAX default frames."""
    blocks = jax.numpy.asarray(np.asarray(jouts[1].history), np.float32)
    assert (np.asarray(jup.depth_to_space(blocks, mode))
            == np.asarray(jup.depth_to_space(blocks, "convt"))).all()
    tr, outs = _port_frames({"d2s_mode": mode})
    assert tr.knobs.d2s_mode == mode
    _tr0, default = _port_frames()
    for out, base in zip(outs, default):
        assert torch.equal(out.color, base.color)
        assert torch.equal(out.history, base.history)
    _hold(tr, outs, jouts)
