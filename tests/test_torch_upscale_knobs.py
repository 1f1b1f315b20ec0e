"""The upscaler's kernel knobs in the port's one-device frame, held against
the JAX package.

  * upscale_v2=False, the V1 reconstruction (apply_upscaler; the next
    frame warps this frame's RGBA8 colour with warp_previous): the two
    chained 128² frames of test_torch_frame._ai_renderer() against the
    JAX frames under the knob (op by op, f32 on both sides), the golden
    gate and aux [0, 0].
  * warp_mxu=False, the warp without the TPU kernel's band window (K8 with
    validity = in_bounds): bitwise against the JAX gather warp as
    tests/test_upscaler.py:392-419 holds it, at a static camera (every
    pixel in the window) and at a moved one (the windowed warp drops some);
    and the chained frames against the JAX frames under the knob.
  * upscale_dtype="bf16", the V2 convs in bf16 as flax runs them (module
    note of ai/upscaler.py): the port's net against the JAX bf16 net on
    the same params and inputs within BF16_TOL, the tolerance measured on
    the CPU (see its note), and each dtype's output against the other's at
    more than 40 dB, the JAX test's bound (tests/test_upscaler.py:368-389).
    The frames under the knob: tests/test_torch_upscale_default.py, whose
    JAX frames are the JAX default (bf16).
  * d2s_mode: the three relayouts are bit-exact in both packages; the
    frames: tests/test_torch_upscale_default.py.
Its own file, so that `--dist loadfile` gives its JAX frames a worker.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ai import upscaler as jup
from trident_tpu.ops import kernel_knobs as jknobs
from trident_tpu.render.camera import EditorCamera

from trident_tpu_torch.ai import upscaler as up

from test_torch_frame import (
    AI_ORBIT,
    _ai_renderer,
    _assert_golden_gate,
    _jax_frame_op_by_op,
)
from test_torch_host import carry_renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# |port − JAX| of the bf16 net's output blocks: both round the same
# bf16 operands after every conv, but their f32 accumulations sum the
# 3×3×C products in different orders, so one accumulation may round to
# the neighbouring bf16 value, which the next layers carry. Measured on
# the CPU: 0 for the perturbed 8-channel net, 0.00049 for the shipped one
# (the f32 nets: 3.0e-7 and 1.8e-7)
BF16_TOL = 1e-3


@pytest.fixture(scope="module")
def shipped():
    """The shipped upscaler as JAX params and as the port's net."""
    params, _bc = jup.load_upscaler(str(ROOT / "assets_out" / "upscaler_2x"))
    net, _bc = up.load_upscaler(device="cpu")
    return params, net


def _jax_chain(jr, params, knobs: dict, history):
    """The JAX package's two AI-upscaled frames of `jr`'s scene under
    `knobs` (the camera orbited between them); frame 1 warps
    history(frame 0)."""
    with jknobs.overrides(upscale_dtype="f32", **knobs):
        out0 = _jax_frame_op_by_op(jr, params)
        p = jr.editor_camera.params()
        vp0 = jnp.matmul(p.proj, p.view, precision=jax.lax.Precision.HIGHEST)
        jr.editor_camera.orbit(*AI_ORBIT)
        out1 = _jax_frame_op_by_op(jr, params, (history(out0), vp0))
    return out0, out1


def _port_chain(jr, kernel):
    tr = carry_renderer(jr, kernel=kernel)
    out0 = tr.render_viewport()
    prev0 = tr.prev_state
    tr.editor_camera.orbit(*AI_ORBIT)
    return tr, prev0, (out0, tr.render_viewport())


def _hold(tr, outs, jouts):
    for k, (out, jout) in enumerate(zip(outs, jouts)):
        assert out.aux.tolist() == [0, 0], k
        assert np.asarray(jout.aux).tolist() == [0, 0], k
        assert out.color.shape == (128, 128, 4), k
        _assert_golden_gate(tr.read_frame(out), np.asarray(jout.color))


def test_v1_frames_match_jax(shipped):
    """upscale_v2=False: no history; the next frame warps the RGBA8 colour
    (the JAX Renderer's prev_state, trident_tpu/render/renderer.py:900)."""
    params, _net = shipped
    jr = _ai_renderer()
    jouts = _jax_chain(jr, params, {"upscale_v2": False},
                       lambda o: o.color)
    jr2 = _ai_renderer()
    tr, prev0, outs = _port_chain(jr2, {"upscale_v2": False})
    assert not tr.knobs.upscale_v2
    assert all(o.history is None for o in outs)
    assert all(o.history is None for o in jouts)
    assert prev0[0] is outs[0].color and prev0[0].shape == (128, 128, 4)
    _hold(tr, outs, jouts)
    # the temporal input of frame 1 is real: ≥ 1% of its pixels valid
    temporal = up.temporal_from_prev(
        tr._upscale_params(), prev0, outs[1].depth[::2, ::2].contiguous(),
        tr.editor_camera.params("cpu"), 128, 128)
    assert float(temporal[..., 12].mean()) >= 0.01


def test_windowless_warp_frames_match_jax(shipped):
    """warp_mxu=False: the chained V2 frames (f32 convs) against the JAX
    frames under the knob."""
    params, _net = shipped
    jouts = _jax_chain(_ai_renderer(), params, {"warp_mxu": False},
                       lambda o: o.history)
    tr, _prev0, outs = _port_chain(_ai_renderer(), {"warp_mxu": False})
    assert not tr.knobs.warp_mxu
    _hold(tr, outs, jouts)


def _warp_case(move: bool):
    """The JAX test's warp inputs (tests/test_upscaler.py:392-419): random
    uint8 blocks, depth with background pixels, the camera's view·proj;
    static at 64² (a 32-row history, inside one band window), or with
    `move` at 192² (96 rows) with the previous view orbited away and the
    depths drawn over 1–10 units from the camera, so that their parallax
    throws some reprojected rows out of their block's two-band window."""
    size = 192 if move else 64
    cam = EditorCamera()
    cam.set_viewport_size(size, size)
    cam.set_position([0, 0, 3])
    cam.look_at_target([0, 0, 0])
    p0 = cam.params()
    vp0 = (np.asarray(p0.proj) @ np.asarray(p0.view)).astype(np.float32)
    prev_vp = vp0
    if move:
        cam.orbit([0, 0, 0], 10.0, 15.0)
        p1 = cam.params()
        prev_vp = (np.asarray(p1.proj) @ np.asarray(p1.view)) \
            .astype(np.float32)
    rng = np.random.default_rng(21)
    half = size // 2
    blocks = rng.integers(0, 256, (half, half, 12)).astype(np.uint8)
    lo, hi = (0.9, 0.99) if move else (0.3, 0.7)
    depth = rng.uniform(lo, hi, (half, half)).astype(np.float32)
    depth[0, :4] = 1.0
    inv = np.linalg.inv(vp0).astype(np.float32)
    return blocks, depth, inv, prev_vp, size


def _bf16_case(shipped):
    """(JAX params, port net, inputs) of the JAX test's bf16 case: an
    8-channel 17-input net with perturbed weights on 32² random inputs
    (tests/test_upscaler.py:368-389); and the shipped net on 64² inputs."""
    _, variables = jup.init_upscaler(jax.random.PRNGKey(8), base_channels=8,
                                     in_channels=17)
    params = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                               a.shape, a.dtype),
        variables["params"])
    rng = np.random.default_rng(15)
    small = (rng.random((32, 32, 3), np.float32),
             rng.random((32, 32, 13), np.float32),
             rng.random((32, 32), np.float32))
    jparams, net = shipped
    rng = np.random.default_rng(16)
    big = (rng.random((64, 64, 3), np.float32),
           rng.random((64, 64, 13), np.float32),
           rng.random((64, 64), np.float32))
    return [(params, up.upscaler_from_flax(params, "cpu"), small),
            (jparams, net, big)]


@pytest.mark.parametrize("case", [0, 1], ids=["perturbed8", "shipped"])
def test_bf16_convs_match_jax_bf16_net(shipped, case):
    params, net, (img, temporal, d) = _bf16_case(shipped)[case]
    outs = {}
    for dtype in ("bf16", "f32"):
        with jknobs.overrides(upscale_dtype=dtype):
            jrgb, jblocks = jup.apply_upscaler_v2(
                params, jnp.asarray(img), jnp.asarray(temporal),
                jnp.asarray(d))
        rgb, blocks = up.apply_upscaler_v2(
            net, torch.from_numpy(img), torch.from_numpy(temporal),
            torch.from_numpy(d), dtype=dtype)
        outs[dtype] = (rgb, np.asarray(jrgb))
        err = np.abs(blocks.numpy() - np.asarray(jblocks)).max()
        assert err <= (BF16_TOL if dtype == "bf16" else 1e-5), (dtype, err)
    rgb16, j16 = outs["bf16"]
    rgb32, j32 = outs["f32"]
    assert float(up.psnr(rgb16, rgb32)) > 40.0
    assert float(jup.psnr(jnp.asarray(j16), jnp.asarray(j32))) > 40.0
    assert not torch.equal(rgb16, rgb32)


def test_d2s_modes_are_one_relayout():
    """depth_to_space's three modes give the same bits in each package,
    and the port's give the JAX package's."""
    rng = np.random.default_rng(5)
    blocks = rng.random((16, 24, 12), np.float32)
    ref = np.asarray(jup.depth_to_space(jnp.asarray(blocks), "xla"))
    for mode in up.D2S_MODES:
        j = np.asarray(jup.depth_to_space(jnp.asarray(blocks), mode))
        p = up.depth_to_space(torch.from_numpy(blocks), mode).numpy()
        assert (j.view(np.int32) == ref.view(np.int32)).all(), mode
        assert (p.view(np.int32) == ref.view(np.int32)).all(), mode
