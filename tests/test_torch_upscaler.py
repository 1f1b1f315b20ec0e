"""Port upscaler (V2 block path) vs the JAX package's ai/upscaler.py.

The shipped weights: the port's numpy export must equal the orbax
checkpoint that the JAX package restores, bit for bit. The net: on
perturbed random weights both packages run their convs in f32 (the JAX
side through the `upscale_dtype="f32"` knob; its default is bf16), so
rgb and blocks agree within 2e-6, the bound allowed for convs that may
sum in different orders (0 measured); the block-layout bilinear base
agrees within 1e-6 (0 measured) and depth-to-space is an exact relayout.
Quality: the shipped net beats bilinear upsampling by more than 0.2 dB at
128→256, the JAX package's own gate (41.47 vs 37.28 dB measured).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ai import upscaler as jup
from trident_tpu.ops import kernel_knobs

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.core.config import AiConfig, EngineConfig, RenderConfig
from trident_tpu_torch.ecs.components import (
    MeshComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.io.image import checkerboard
from trident_tpu_torch.render.renderer import Renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "assets_out" / "upscaler_2x"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_npz_equals_orbax_checkpoint():
    params, bc = jup.load_upscaler(str(CHECKPOINT))
    want = _flat(params)
    with np.load(up.DEFAULT_WEIGHTS) as z:
        got = {k: z[k] for k in z.files}
    meta = {k: int(got.pop(k)) for k in list(got) if "/" not in k}
    assert meta == {"base_channels": 32, "scale": 2, "in_channels": 16}
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert got[k].tobytes() == a.tobytes(), k
    assert sum(a.size for a in got.values()) == 26604

    net, pbc = up.load_upscaler(device="cpu")
    assert pbc == bc == 32 and up.upscaler_in_channels(net) == 16
    assert up.upscaler_wants_temporal(net) and not up.upscaler_wants_depth(net)
    assert not any(p.requires_grad for p in net.parameters())


def test_params_from_flax_round_trips_shapes():
    """HWIO kernels → OIHW weights, and back to the same arrays."""
    params, _bc = jup.load_upscaler(str(CHECKPOINT))
    state = up.params_from_flax(params)
    ref = up.UpscalerNet(16, 32).state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32, k
    for i in range(4):
        back = state[f"convs.{i}.weight"].numpy().transpose(2, 3, 1, 0)
        assert (back == np.asarray(params[f"Conv_{i}"]["kernel"])).all()
        assert (state[f"convs.{i}.bias"].numpy()
                == np.asarray(params[f"Conv_{i}"]["bias"])).all()


def _perturbed_params(in_channels: int, seed: int):
    """init_upscaler's params (base 8) + 0.05·N(0, 1) from numpy, so the
    zero-init head is exercised."""
    _, variables = jup.init_upscaler(jax.random.PRNGKey(5), base_channels=8,
                                     in_channels=in_channels)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), variables["params"])


@pytest.mark.parametrize("in_channels", [16, 17])
def test_apply_upscaler_v2_matches_jax(in_channels):
    params = _perturbed_params(in_channels, 40 + in_channels)
    net = up.upscaler_from_flax(params, "cpu")
    rng = np.random.default_rng(13)
    img = rng.random((16, 24, 3), np.float32)
    temporal = rng.random((16, 24, 13), np.float32)
    d = rng.random((16, 24), np.float32)
    with kernel_knobs.overrides(upscale_dtype="f32"):
        jrgb, jblocks = jup.apply_upscaler_v2(
            params, jnp.asarray(img), jnp.asarray(temporal), jnp.asarray(d))
    rgb, blocks = up.apply_upscaler_v2(
        net, torch.from_numpy(img), torch.from_numpy(temporal),
        torch.from_numpy(d))
    assert rgb.shape == (32, 48, 3) and blocks.shape == (16, 24, 12)
    assert np.abs(blocks.numpy() - np.asarray(jblocks)).max() <= 2e-6
    assert np.abs(rgb.numpy() - np.asarray(jrgb)).max() <= 2e-6
    # the residual did something: the output is not the bilinear base
    base = up.base_blocks(torch.from_numpy(img)).clamp(0, 1)
    assert (blocks - base).abs().max() > 0.01


def test_base_blocks_and_depth_to_space_match_jax():
    rng = np.random.default_rng(12)
    img = rng.random((32, 48, 3), np.float32)
    want = np.asarray(jup.base_blocks(jnp.asarray(img)))
    got = up.base_blocks(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (32, 48, 12)
    assert np.abs(got - want).max() <= 1e-6
    blocks = rng.random((24, 40, 12), np.float32)
    for mode in ("xla", "convt"):
        want = np.asarray(jup.depth_to_space(jnp.asarray(blocks), mode=mode))
        got = up.depth_to_space(torch.from_numpy(blocks)).numpy()
        assert got.shape == (48, 80, 3) and (got == want).all(), mode
    # batched, and the channel (dy·2+dx)·3+c → pixel (2y+dy, 2x+dx) order
    batched = up.depth_to_space(torch.from_numpy(np.stack([blocks] * 2)))
    assert batched.shape == (2, 48, 80, 3)
    assert float(batched[1, 2 * 5 + 1, 2 * 7 + 0, 2]) == blocks[5, 7, 2 * 3 + 2]
    u8 = up.blocks_to_u8(torch.from_numpy(blocks)).numpy()
    assert (u8 == np.asarray(jup.blocks_to_u8(jnp.asarray(blocks)))).all()


def _cube_renderer(size: int, **render_kw):
    """test_upscaler.py's `_scene` on the port: one textured cube at
    (0, 0, 3)."""
    r = Renderer(EngineConfig(render=RenderConfig(
        width=size, height=size, **render_kw)), device="cpu")
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_shipped_net_beats_bilinear():
    """Twin of test_shipped_checkpoint_beats_bilinear_psnr: the cube
    rendered at 256² is the target; at 128² the input; the target's own
    blocks (static camera: an identity warp) are the history."""
    net, _bc = up.load_upscaler(device="cpu")
    r = _cube_renderer(256)
    full = r.render_viewport()
    target = full.color[..., :3].float() / 255.0
    cam = r.editor_camera.params("cpu")
    vp = cam.proj @ cam.view
    hist = (full.color[..., :3].reshape(128, 2, 128, 2, 3)
            .permute(0, 2, 1, 3, 4).reshape(128, 128, 12).contiguous())
    r.config.render.width = r.config.render.height = 128
    half_out = r.render_viewport()
    half = half_out.color[..., :3].float() / 255.0
    temporal = up.warp_from_blocks(hist, half_out.depth, torch.linalg.inv(vp),
                                   vp, 256, 256)
    assert float(temporal[..., 12].mean()) > 0.05
    rgb, _blocks = up.apply_upscaler_v2(net, half, temporal)
    bilinear = up.depth_to_space(up.base_blocks(half))
    p_net = float(up.psnr(rgb, target))
    p_bil = float(up.psnr(bilinear.clamp(0, 1), target))
    assert p_net > p_bil + 0.2, (p_net, p_bil)


def test_renderer_raises_without_weights(tmp_path):
    """ai_upscale with weights that cannot be loaded raises at
    construction; the JAX package would log and render at native size."""
    missing = str(tmp_path / "nope.npz")
    with pytest.raises(OSError):
        Renderer(EngineConfig(render=RenderConfig(ai_upscale=True),
                              ai=AiConfig(upscaler_path=missing)),
                 device="cpu")
    r = Renderer(EngineConfig(render=RenderConfig(ai_upscale=False),
                              ai=AiConfig(upscaler_path=missing)),
                 device="cpu")
    assert r._upscale_params() is None


def test_odd_target_renders_native():
    """An odd target cannot be reached by 2× reconstruction: it renders at
    native size without the net, as the JAX Renderer does."""
    r = _cube_renderer(65, ai_upscale=True)
    out = r.render_viewport()
    assert out.color.shape == (65, 65, 4) and out.history is None
    assert r.prev_state is None
