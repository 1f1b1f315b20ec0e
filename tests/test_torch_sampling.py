"""Nearest and trilinear texture sampling on the port against the JAX
package's samplers (trident_tpu/ops/shading.py:_nearest_flat,
sample_texture_mip), the frame path's trilinear (the texel kernel's plain
version at the two levels) against the plain sampler, the
flavor_trilinear and nearest scenes' frames against the JAX frames, and
the tiled-shade gate, which admits bilinear frames only, as the JAX
package's does (trident_tpu/render/renderer.py:141).

The samplers are compared bit for bit against the JAX functions evaluated
op by op (each elementwise op rounds once in both packages).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import shading as jshading

from trident_tpu_torch.ops import deferred, resolve, shading
from trident_tpu_torch.render import renderer as renderer_mod
from trident_tpu_torch.tools_dev.scenes import feature_scene

from test_torch_frame import (
    _assert_golden_gate,
    check_feature_frame,
    jax_feature_frame,
)
from test_torch_texel import SIZES, _lookup_inputs, _textures

torch.set_num_threads(1)


def _mips(shape, seed=8):
    mip = np.random.default_rng(seed).uniform(-1.0, 9.0, shape)
    mip = mip.astype(np.float32)
    mip[:4, :4] = 2.5                       # ties round to even
    mip[4:8, :4] = 3.0                      # integer levels: frac 0
    return mip


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
def test_sample_texture_matches_jax(mode):
    jt, pt = _textures()
    uv, _level, rows = _lookup_inputs(jt)
    mip = _mips(uv.shape[:2])
    with jax.disable_jit():
        ref = np.asarray(jshading.sample_texture(
            jt, None, jnp.asarray(uv), jnp.asarray(mip), mode=mode,
            size_hint=tuple(jnp.asarray(rows[..., k]) for k in range(4))))
    out = shading.sample_texture(
        pt, torch.from_numpy(uv), torch.from_numpy(mip), mode=mode,
        size_hint=tuple(torch.from_numpy(rows[..., k]) for k in range(4)))
    assert out.shape == ref.shape == (*uv.shape[:2], 4)
    assert (out.numpy().view(np.int32) == ref.view(np.int32)).all()


def test_unknown_sampling_mode_raises():
    _jt, pt = _textures()
    with pytest.raises(ValueError, match="sampling"):
        shading.sample_texture(pt, torch.zeros(2, 2, 2), torch.zeros(2, 2),
                               mode="anisotropic",
                               size_hint=(torch.ones(2, 2, dtype=torch.int32),) * 4)
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig

    with pytest.raises(ValueError, match="sampling"):
        renderer_mod.Renderer(EngineConfig(render=RenderConfig(
            sampling="anisotropic")), device="cpu")


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
def test_frame_sampler_equals_plain_sampler(mode):
    """deferred.sample_attrs_texture (the frame's sampler: the texel
    kernel's wrapper at one or two levels, or one gather) on a resolved
    attribute image equals shading.sample_texture on the same attributes,
    bit for bit on the covered pixels."""
    jt, pt = _textures()
    rng = np.random.default_rng(4)
    h, w = 32, 64
    attrs = np.zeros((h, w, resolve.CHANNELS), np.float32)
    sizes = np.asarray(jt.sizes)
    slot = rng.integers(1, len(SIZES) + 1, (h, w))
    attrs[..., resolve.CH_U:resolve.CH_V + 1] = rng.uniform(-1, 2, (h, w, 2))
    attrs[..., resolve.CH_MIP] = _mips((h, w), 6)
    attrs[..., resolve.CH_TSX] = sizes[slot, 0]
    attrs[..., resolve.CH_TSY] = sizes[slot, 1]
    attrs[..., resolve.CH_BASE8] = sizes[slot, 2]
    covered = rng.uniform(size=(h, w)) < 0.8
    a = torch.from_numpy(attrs)
    got = deferred.sample_attrs_texture(a, torch.from_numpy(covered), pt,
                                        mode).numpy()
    ref = shading.sample_texture(
        pt, a[..., resolve.CH_U:resolve.CH_V + 1], a[..., resolve.CH_MIP],
        mode=mode, size_hint=deferred.size_hint(a)).numpy()
    assert (got[covered].view(np.int32) == ref[covered].view(np.int32)).all()


@pytest.mark.parametrize("name", ["trilinear", "nearest"])
def test_sampling_frame_matches_jax(name, tmp_path):
    """flavor_trilinear (the `_base` scene, the checker tiled 9 times) and
    its nearest twin against the JAX frames; the mode changes the frame."""
    _r, out, _j = check_feature_frame(name, tmp_path)
    bilinear = feature_scene(name, "cpu", sampling="bilinear") \
        .render_viewport()
    assert (out.color != bilinear.color).any()


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_tiled_shade_gate_refuses_non_bilinear(mode, monkeypatch):
    """With tiled_shade on, a frame that samples other than bilinearly
    takes the (H, W) path, bit-equal to the frame without the knob, as
    the JAX package's gate decides: its tiled_shade frame equals its
    frame without the knob too."""
    knob = {"tiled_shade": True}
    _jr, jtiled = jax_feature_frame(mode, kernel=knob)
    _jr, jplain = jax_feature_frame(mode)
    assert (np.asarray(jtiled.color) == np.asarray(jplain.color)).all()

    def refuse(*_a, **_k):
        raise AssertionError("the tiled shading path ran")

    plain = feature_scene(mode, "cpu").render_viewport()
    with monkeypatch.context() as m:
        m.setattr(renderer_mod, "shade_attrs_tiled", refuse)
        tiled = feature_scene(mode, "cpu", kernel=knob).render_viewport()
    assert (tiled.color == plain.color).all()
    _assert_golden_gate(tiled.color.numpy(), np.asarray(jtiled.color))
    # a bilinear frame with the knob does take the tiled path
    with pytest.raises(AssertionError, match="tiled shading"):
        with monkeypatch.context() as m:
            m.setattr(renderer_mod, "shade_attrs_tiled", refuse)
            feature_scene(mode, "cpu", kernel=knob,
                          sampling="bilinear").render_viewport()
