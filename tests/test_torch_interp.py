"""The frame-interpolation net's inference path on trident_tpu_torch against
the JAX package, on the CPU: the exported weights, InterpolationUNet,
psnr / ssim, FrameGenerator, and the AI-frame blend of the Renderer.

The net's convolutions are library calls in both packages (XLA's and
PyTorch's), so the two nets agree to float rounding: within 1e-5 on
sigmoid outputs in [0, 1]. chip_smoke.py holds the net on the card
against itself on the CPU (phase 13).
"""

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ai import metrics as jmetrics
from trident_tpu.ai.frame_generator import FrameGenerator as JFrameGenerator
from trident_tpu.ai.model import InterpolationUNet as JInterpolationUNet
from trident_tpu.ai.train import load_checkpoint
from trident_tpu.render.types import AiBlend as JAiBlend

from trident_tpu_torch.ai import metrics
from trident_tpu_torch.ai.frame_generator import FrameGenerator
from trident_tpu_torch.ai.model import (
    DEFAULT_WEIGHTS,
    InterpolationUNet,
    load_frame_generator,
    unet_flops,
    unet_from_flax,
)
from trident_tpu_torch.render.renderer import render_frame

from test_torch_frame import (
    _assert_golden_gate,
    _flavor_renderer,
    _jax_frame_op_by_op,
)
from test_torch_frame_loop import _same
from test_torch_host import carry_renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "assets_out" / "frame_generator_128"
NET_TOL = 1e-5


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            out.update(_flatten(dict(tree[k]), f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


@pytest.fixture(scope="module")
def jax_checkpoint():
    return load_checkpoint(str(CKPT))


def test_npz_equals_the_orbax_restore_bitwise(jax_checkpoint):
    """assets/frame_generator_128.npz holds every params / batch_stats
    array of the orbax checkpoint under its flax name, bit for bit, and
    its base_channels."""
    model, variables = jax_checkpoint
    want = _flatten({"params": variables["params"],
                     "batch_stats": variables["batch_stats"]})
    with np.load(DEFAULT_WEIGHTS) as z:
        got = {k: z[k] for k in z.files}
    assert int(got.pop("base_channels")) == model.base_channels == 16
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert got[k].tobytes() == a.tobytes(), k
    assert sum(a.size for a in want.values()) == 335027


def test_unet_from_npz_matches_the_jax_checkpoint(jax_checkpoint):
    model, variables = jax_checkpoint
    net, bc = load_frame_generator(device="cpu")
    assert bc == 16 and not net.training
    x = np.random.default_rng(0).random((2, 64, 64, 6), np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 64, 64, 3)
    assert np.abs(got - want).max() <= NET_TOL


def test_random_base8_unet_matches_jax():
    """A base-8 net with random weights and random batch statistics, made
    with numpy on the flax variables' shapes: every weight (the transposed
    convs' flipped kernels among them) maps across."""
    model = JInterpolationUNet(base_channels=8)
    x = np.random.default_rng(4).random((1, 32, 32, 6), np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.2, a.shape).astype(np.float32),
        shapes["params"])
    stats = {blk: {bn: {"mean": rng.normal(0, 0.5, v["mean"].shape)
                        .astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, v["var"].shape)
                        .astype(np.float32)}
                   for bn, v in d.items()}
             for blk, d in shapes["batch_stats"].items()}
    want = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    net = unet_from_flax(params, stats, "cpu")
    assert isinstance(net, InterpolationUNet) and net.base_channels == 8
    with torch.inference_mode():
        got = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= NET_TOL


def test_unet_flops_count_the_shipped_net():
    # 2·9·C_in·C_out per output pixel of each conv, 2·16·C_in·C_out per
    # input pixel of each transposed conv, base 16 at 256²
    assert unet_flops(16, 256, 256) == 5_236_588_544


def test_load_rejects_anything_but_the_npz():
    with pytest.raises(ValueError, match="export_frame_generator_npz"):
        load_frame_generator(CKPT, "cpu")


@pytest.mark.parametrize("hw", [(24, 20), (11, 11)])
def test_psnr_and_ssim_match_jax(hw):
    rng = np.random.default_rng(5)
    a = rng.random((2, *hw, 3), np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    assert float(metrics.psnr(_nchw(a), _nchw(b))) == pytest.approx(
        float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    assert float(metrics.ssim(_nchw(a), _nchw(b))) == pytest.approx(
        float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    assert float(metrics.ssim(_nchw(a), _nchw(a))) == pytest.approx(1.0,
                                                                   abs=1e-5)


# -- FrameGenerator -------------------------------------------------------------

@pytest.mark.parametrize("src", [(256, 256), (1080, 1920), (37, 53), (9, 300)])
def test_resize_is_the_jax_resize_bitwise(src):
    frame = np.random.default_rng(6).random((*src, 3)).astype(np.float32)
    for res in ((256, 256), (64, 48)):
        want = JFrameGenerator(resolution=res)._resize(frame)
        got = FrameGenerator(resolution=res, device="cpu")._resize(frame)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _poll(gen, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        got = gen.try_consume_output()
        if got is not None:
            return got
        time.sleep(0.01)
    return None


def test_frame_generator_pairs_frames_and_reports():
    """The first frame has no pair; each later one pairs with the one
    before (resized bilinearly); the output is the net's middle frame, and
    the telemetry fills in."""
    net, _bc = load_frame_generator(device="cpu")
    gen = FrameGenerator(resolution=(32, 32), device="cpu")
    assert gen.initialise(net=net)
    rng = np.random.default_rng(7)
    f0, f1 = (rng.random((48, 40, 3)).astype(np.float32) for _ in range(2))
    try:
        assert gen.process_frame(f0) is None
        assert gen.process_frame(f1) == 0
        got = _poll(gen)
        # a frame of another size restarts the pairing
        assert gen.process_frame(f0[:32]) is None
    finally:
        gen.shutdown()
    assert got is not None and got[0] == 0
    pair = np.concatenate([gen._resize(f0), gen._resize(f1)], axis=-1)
    with torch.inference_mode():
        want = net(_nchw(pair[None]))[0].permute(1, 2, 0).numpy()
    assert got[1].shape == (32, 32, 3) and (got[1] == want).all()
    st = gen.stats
    assert st.completed_count == 1 and st.last_inference_ms > 0
    assert st.average_inference_ms == st.last_inference_ms
    assert not st.enabled and gen.process_frame(f1) is None


class _Gate(torch.nn.Module):
    """A stand-in net whose forward waits for `go`: the worker stays busy
    on its first job."""

    def __init__(self):
        super().__init__()
        self.go, self.entered = threading.Event(), threading.Event()

    def forward(self, x):
        self.entered.set()
        assert self.go.wait(30.0)
        return x[:, :3]


def test_frame_generator_drops_when_full():
    net = _Gate()
    gen = FrameGenerator(resolution=(8, 8), queue_limit=2, device="cpu")
    assert gen.initialise(net=net)
    frames = [np.full((8, 8, 3), k / 8, np.float32) for k in range(5)]
    try:
        assert gen.process_frame(frames[0]) is None
        assert gen.process_frame(frames[1]) == 0
        assert net.entered.wait(30.0)              # job 0 on the worker
        assert gen.process_frame(frames[2]) == 1
        assert gen.process_frame(frames[3]) == 2
        assert gen.process_frame(frames[4]) is None   # queue full: dropped
        assert gen.stats.queue_depth == 2
        net.go.set()
        assert [_poll(gen)[0] for _ in range(3)] == [0, 1, 2]
    finally:
        net.go.set()
        gen.shutdown()


def test_reinitialise_drains_a_stale_sentinel():
    """A shutdown while the worker is busy leaves its sentinel behind a
    stale job (the worker exits by the running flag); initialise drains
    both, so the new worker neither dies on the sentinel nor runs the
    stale job."""
    net = _Gate()
    gen = FrameGenerator(resolution=(8, 8), queue_limit=2, device="cpu")
    assert gen.initialise(net=net)
    frames = [np.full((8, 8, 3), k / 8, np.float32) for k in range(4)]
    try:
        assert gen.process_frame(frames[0]) is None
        assert gen.process_frame(frames[1]) == 0
        assert net.entered.wait(30.0)              # job 0 on the worker
        assert gen.process_frame(frames[2]) == 1   # stale once shut down
        old = gen._worker
        stop = threading.Thread(target=gen.shutdown)
        stop.start()
        while gen._jobs.qsize() < 2:               # job 1, then the sentinel
            time.sleep(0.001)
        net.go.set()
        stop.join(30.0)
        assert not stop.is_alive() and not old.is_alive()
        assert gen._jobs.qsize() == 2
        assert gen.initialise(net=net)
        assert gen._jobs.qsize() == 0
        assert gen.process_frame(frames[3]) == 2
        got = [_poll(gen)[0] for _ in range(2)]
    finally:
        net.go.set()
        gen.shutdown()
    assert got == [0, 2]                           # job 1 never ran
    assert not gen._worker.is_alive()


def test_initialise_raises_on_a_file_it_cannot_load(tmp_path):
    bad = tmp_path / "frame_generator.npz"
    bad.write_bytes(b"not a zip")
    gen = FrameGenerator(device="cpu")
    with pytest.raises((ValueError, OSError)):
        gen.initialise(bad)
    assert not gen.stats.enabled
    assert gen.initialise() is False                 # nothing to run


# -- the AI-frame blend ---------------------------------------------------------

def _ai_image(h, w, seed=8):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def test_ai_blend_matches_the_jax_frame():
    """The `_base` scene at 128² with set_ai_frame(img, 0.5) against the
    JAX frame with the same AiBlend, under the golden gate; the blend
    changes the frame."""
    jr = _flavor_renderer("forward", {"forward": {}})
    tr = carry_renderer(jr)
    plain = tr.render_viewport()
    img = _ai_image(128, 128)
    jout = _jax_frame_op_by_op(jr, ai=JAiBlend(
        image=jnp.asarray(img), blend=jnp.asarray(0.5, jnp.float32)))
    tr.set_ai_frame(img, 0.5)
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert (out.tri_id.numpy() == np.asarray(jout.tri_id)).all()
    _assert_golden_gate(tr.read_frame(out), np.asarray(jout.color))
    assert (out.color != plain.color).any()


def test_bundled_blend_equals_render_frame_and_misses_the_idle_cache():
    """render_viewport (the bundled frame, the blend from the blob) equals
    render_frame on frame_inputs bit for bit; each set_ai_frame misses the
    idle cache; blend 0 and no image equal no blend."""
    tr = carry_renderer(_flavor_renderer("bloom"), width=64, height=48)
    tr.editor_camera.set_viewport_size(64, 48)
    plain = tr.render_viewport()
    assert tr.render_viewport() is plain               # idle
    tr.set_ai_frame(_ai_image(48, 64), 0.5)
    out = tr.render_viewport()
    assert out is not plain
    assert not _same(out, render_frame(**tr.frame_inputs()))
    assert (out.color != plain.color).any()
    assert tr.render_viewport() is out                 # idle again
    tr.set_ai_frame(_ai_image(48, 64, seed=9), 0.5)    # a new AI frame
    again = tr.render_viewport()
    assert again is not out and (again.color != out.color).any()
    for image, blend in ((_ai_image(48, 64), 0.0), (None, 0.5),
                         (_ai_image(48, 64), -1.0)):
        tr.set_ai_frame(image, blend)
        off = tr.render_viewport()
        assert not _same(off, plain), (image is None, blend)
    with pytest.raises(ValueError, match="H, W, 3"):
        tr.set_ai_frame(np.zeros((48, 64), np.float32), 0.5)


def test_blend_above_one_is_clipped():
    tr = carry_renderer(_flavor_renderer("ssaa"), width=32, height=32,
                        supersample=1)
    img = _ai_image(32, 32)
    tr.set_ai_frame(img, 1.0)
    full = tr.render_viewport()
    tr.set_ai_frame(img, 3.0)
    assert not _same(tr.render_viewport(), full)
    want = np.round(np.concatenate([img, np.ones((32, 32, 1), np.float32)],
                                   -1) * 255.0).astype(np.uint8)
    assert (full.color.numpy() == want).all()
