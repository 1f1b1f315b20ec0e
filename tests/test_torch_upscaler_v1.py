"""The port's V1 upscaler path (the banded frame's: apply_upscaler,
resize_bilinear_2x, warp_previous and temporal_from_prev's V1 branch)
against the JAX package's ai/upscaler.py.

Tolerances, with their reasons:
  * resize_bilinear_2x against jax.image.resize(…, "bilinear") at 2×:
    within 2.4e-7 (two ulps at 1.0) of values in [0, 1], the corners exact
    copies of the input's. Each output is a two-term lerp with the same
    weights, but XLA evaluates each axis as a dot over a weight matrix
    whose FMA accumulation order follows its blocking and shape, so the
    last bit differs at many pixels (about a third at 16×24). The
    block-layout base of the V2 path (base_blocks, depth-to-spaced) also
    differs from it in the last bit (asserted), and not only at the
    ends, which is why V1 has a resize of its own;
  * apply_upscaler on perturbed random weights, convs in f32 on both
    sides: within 2e-6 (the convs may sum in different orders, as in
    test_torch_upscaler.py);
  * warp_previous and the V1 temporal_from_prev on the same matrices,
    depth and history: the same block and validity except where the
    reprojected px·0.5 − 0.5 or py·0.5 − 0.5 lies within 1e-4 of a
    rounding boundary (the 4×4 products may round differently), < 0.5%
    of pixels; elsewhere bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ai import upscaler as jup
from trident_tpu.render.camera import EditorCamera as JEditorCamera
from trident_tpu.render.types import CameraParams as JCameraParams

from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.render.camera import EditorCamera
from trident_tpu_torch.render.types import CameraParams

from test_torch_upscaler import _perturbed_params

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(16, 24, 3), (33, 17, 3), (64, 64, 3)])
def test_resize_bilinear_2x_matches_jax_resize(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.random(shape, np.float32)
    h, w, c = shape
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2 * h, 2 * w, c),
                                       "bilinear"))
    got = up.resize_bilinear_2x(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2.4e-7
    for a in (got, want):          # the corners copy the input's
        assert (a[[0, -1]][:, [0, -1]] == img[[0, -1]][:, [0, -1]]).all()
    v2 = up.depth_to_space(up.base_blocks(torch.from_numpy(img))).numpy()
    assert (v2.view(np.int32) != want.view(np.int32)).any()


@pytest.mark.parametrize("in_channels", [16, 17])
def test_apply_upscaler_v1_matches_jax(in_channels):
    params = _perturbed_params(in_channels, 60 + in_channels)
    net = up.upscaler_from_flax(params, "cpu")
    rng = np.random.default_rng(31)
    img = rng.random((16, 24, 3), np.float32)
    temporal = rng.random((16, 24, 13), np.float32)
    d = rng.random((16, 24), np.float32)
    want = np.asarray(jup.apply_upscaler(params, jnp.asarray(img),
                                         jnp.asarray(temporal),
                                         jnp.asarray(d)))
    got = up.apply_upscaler(net, torch.from_numpy(img),
                            torch.from_numpy(temporal),
                            torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (32, 48, 3)
    assert np.abs(got - want).max() <= 2e-6
    # the detail did something: the output is not the resize
    base = up.resize_bilinear_2x(torch.from_numpy(img)).clamp(0, 1).numpy()
    assert np.abs(got - base).max() > 0.01
    # V1 and V2 share the net: the same head, a different base
    rgb2, _blocks = up.apply_upscaler_v2(net, torch.from_numpy(img),
                                         torch.from_numpy(temporal),
                                         torch.from_numpy(d))
    assert np.abs(rgb2.numpy() - got).max() <= 2.4e-7


def _cameras(orbit: bool):
    """(JAX camera, port camera) of a 64² viewport at (0, 0, 3) after
    orbit([0,0,0], 6, 4) or unmoved, and the view·proj before the orbit
    (numpy); the two cameras' matrices are equal."""
    out = []
    for cls in (JEditorCamera, EditorCamera):
        cam = cls()
        cam.set_viewport_size(64, 64)
        cam.set_position([0, 0, 3])
        cam.look_at_target([0, 0, 0])
        prev = (np.asarray(cam.proj) @ np.asarray(cam.view)).astype(np.float32)
        if orbit:
            cam.orbit([0, 0, 0], 6.0, 4.0)
        out.append((np.asarray(cam.view, np.float32),
                    np.asarray(cam.proj, np.float32),
                    np.asarray(cam.position, np.float32), prev))
    (jv, jp, jpos, jprev), (pv, pp, ppos, pprev) = out
    assert (jv == pv).all() and (jp == pp).all() and (jprev == pprev).all()
    return jv, jp, jpos, jprev


def _scene(orbit: bool):
    rng = np.random.default_rng(41 if orbit else 40)
    depth = rng.uniform(0.2, 0.9, (32, 32)).astype(np.float32)
    depth[0, :4] = 1.0                    # background → invalid
    color = rng.integers(0, 256, (64, 64, 4)).astype(np.uint8)
    return depth, color


def _near_boundary_only(got, want, depth, inv, prev_vp):
    px, py, _pw = up._reproject_half(torch.from_numpy(depth),
                                     torch.from_numpy(inv),
                                     torch.from_numpy(prev_vp), 64, 64)

    def near(v):
        v = v.numpy().astype(np.float64) * 0.5 - 0.5
        return np.abs(v - np.floor(v) - 0.5) < 1e-4

    differ = (got != want).any(-1)
    assert not (differ & ~(near(px) | near(py))).any()
    assert differ.mean() < 0.005
    valid = want[..., 12] == 1.0
    assert valid.any() and (~valid).any()


@pytest.mark.parametrize("orbit", [False, True], ids=["static", "orbit"])
def test_warp_previous_matches_jax(orbit):
    view, proj, _pos, prev_vp = _cameras(orbit)
    depth, color = _scene(orbit)
    prev_rgb = color[..., :3].astype(np.float32) * np.float32(1 / 255)
    inv = np.linalg.inv(proj @ view).astype(np.float32)
    want = np.asarray(jup.warp_previous(
        jnp.asarray(prev_rgb), jnp.asarray(depth), jnp.asarray(inv),
        jnp.asarray(prev_vp), 64, 64))
    got = up.warp_previous(*(torch.from_numpy(a) for a in (
        prev_rgb, depth, inv, prev_vp)), 64, 64).numpy()
    assert got.shape == want.shape == (32, 32, 13)
    _near_boundary_only(got, want, depth, inv, prev_vp)


@pytest.mark.parametrize("orbit", [False, True], ids=["static", "orbit"])
def test_temporal_from_prev_v1_matches_jax(orbit):
    """The previous frame's RGBA8 colour as the history: its rgb scaled
    by 1/255 and warped (the banded frame's history); a spatial-only net
    or no history gives None."""
    view, proj, pos, prev_vp = _cameras(orbit)
    depth, color = _scene(orbit)
    params = _perturbed_params(16, 70)
    net = up.upscaler_from_flax(params, "cpu")
    jcam = JCameraParams(view=jnp.asarray(view), proj=jnp.asarray(proj),
                         position=jnp.asarray(pos))
    pcam = CameraParams(view=torch.from_numpy(view),
                        proj=torch.from_numpy(proj),
                        position=torch.from_numpy(pos))
    want = np.asarray(jup.temporal_from_prev(
        params, (jnp.asarray(color), jnp.asarray(prev_vp)),
        jnp.asarray(depth), jcam, 64, 64))
    got = up.temporal_from_prev(
        net, (torch.from_numpy(color), torch.from_numpy(prev_vp)),
        torch.from_numpy(depth), pcam, 64, 64).numpy()
    assert got.shape == want.shape == (32, 32, 13)
    inv = torch.linalg.inv(pcam.proj @ pcam.view).numpy()
    _near_boundary_only(got, want, depth, inv, prev_vp)
    assert up.temporal_from_prev(net, None, torch.from_numpy(depth), pcam,
                                 64, 64) is None
    spatial = up.upscaler_from_flax(_perturbed_params(3, 71), "cpu")
    assert up.temporal_from_prev(
        spatial, (torch.from_numpy(color), torch.from_numpy(prev_vp)),
        torch.from_numpy(depth), pcam, 64, 64) is None
