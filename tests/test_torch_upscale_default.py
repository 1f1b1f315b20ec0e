"""The default 2× frame against the JAX package's default 2× frame.

The JAX package runs the upscaler's convolutions in bf16 by default
(trident_tpu/ai/upscaler.py UPSCALE_DTYPE); the port runs them in f32
(ops/kernel_knobs.py PORT_VALUES). test_torch_frame.py holds the port
against the JAX frames with f32 forced on the JAX side; this file holds the
port's default Renderer against the JAX package's default frames (bf16
convs, no upscale_dtype override, the Pallas warp interpreted): the two
chained 128² AI-upscaled frames of test_torch_frame._ai_renderer() under
the golden gate, aux [0, 0] on both sides. Its own file, so that
`--dist loadfile` gives it a worker of its own (about a minute on the CPU;
`pytest -s` prints each frame's drift).
"""

import pathlib

import numpy as np

import jax

from trident_tpu.ai import upscaler as jup
from trident_tpu.ai.upscaler import load_upscaler
from trident_tpu.ops import kernel_knobs as jknobs

from trident_tpu_torch.ops import kernel_knobs

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


def test_default_upscaled_frames_match_jax_default():
    assert kernel_knobs.PORT_VALUES["upscale_dtype"] == "f32"
    assert kernel_knobs.JAX_DEFAULTS["upscale_dtype"] == "bf16"
    jr = _ai_renderer()
    tr = carry_renderer(jr)
    assert tr.config.render.kernel is None
    jouts = _jax_default_frames(jr)
    outs = [tr.render_viewport()]
    tr.editor_camera.orbit(*AI_ORBIT)
    outs.append(tr.render_viewport())
    for k, (out, jout) in enumerate(zip(outs, jouts)):
        assert out.aux.tolist() == [0, 0], k
        assert np.asarray(jout.aux).tolist() == [0, 0], k
        assert out.color.shape == (128, 128, 4), k
        frame, ref = tr.read_frame(out), np.asarray(jout.color)
        diff = np.abs(frame.astype(np.int32) - ref.astype(np.int32))
        print(f"frame {k}: {int((diff > 3).sum())} values off by > 3 LSB, "
              f"max {int(diff.max())}, mean {diff.mean():.4f}")
        _assert_golden_gate(frame, ref)
