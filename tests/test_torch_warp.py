"""Port warp fetch and V2 warp vs the JAX package's warp kernel and warp.

The fetch is exact on both sides (uint8 bytes are bf16-exact and the TPU
kernel's one-hot products add one nonzero term), so `warp_fetch_ref` must
equal the interpreted `warp_fetch_mxu` bit for bit, −1 pixels included,
and `band_ok_mask` must equal the JAX mask exactly. The whole warp
(`warp_from_blocks`) is compared on identical matrices, depth and history:
bit-equal, except where PyTorch's CPU matmul and XLA's dot round the
reprojection differently and a block index flips at a rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trident_tpu.ai import upscaler as jup
from trident_tpu.ops import kernel_knobs
from trident_tpu.ops import warp_pallas as jwp
from trident_tpu.render.camera import EditorCamera as JEditorCamera

from trident_tpu_torch import _build
from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.ops import warp
from trident_tpu_torch.render.camera import EditorCamera

torch.set_num_threads(1)


def test_warp_fetch_ref_matches_pallas_kernel():
    """test_warp_fetch_mxu_direct's shapes: indices within one band
    window, a run of −1 sentinels."""
    rng = np.random.default_rng(31)
    blocks = rng.integers(0, 256, (96, 64, 12)).astype(np.uint8)
    by = rng.integers(0, 24, (16, 40)).astype(np.int32)
    bx = rng.integers(0, 64, (16, 40)).astype(np.int32)
    by[3, :7] = -1
    bx[3, :7] = -1
    planes, _h, _w = jwp.build_warp_planes(jnp.asarray(blocks))
    want = np.asarray(jwp.warp_fetch_mxu(planes, jnp.asarray(by),
                                         jnp.asarray(bx), interpret=True))
    args = (torch.from_numpy(blocks), torch.from_numpy(by),
            torch.from_numpy(bx))
    got = warp.warp_fetch_ref(*args).numpy()
    assert got.dtype == np.float32 and got.shape == (16, 40, 12)
    assert (got != want).sum() == 0
    assert (got[3, :7] == 0).all()
    # the wrapper takes the plain version for CPU tensors: no launch
    launches = dict(_build.LAUNCHES)
    assert (warp.warp_fetch(*args).numpy() == got).all()
    assert dict(_build.LAUNCHES) == launches


@pytest.mark.parametrize("shape,hist_h", [((20, 300), 200), ((37, 64), 96),
                                          ((8, 256), 10)])
def test_band_ok_mask_matches_jax(shape, hist_h):
    """Blocks of 8×256 pixels, ragged edges; above 64 history rows the
    rows spread over several bands, so some pixels fall outside their
    block's window."""
    rng = np.random.default_rng(hist_h)
    by = rng.integers(0, hist_h, shape).astype(np.int32)
    in_bounds = rng.random(shape) < 0.8
    planes, _h, _w = jwp.build_warp_planes(
        jnp.zeros((hist_h, 16, 12), jnp.uint8))
    hpad = warp.warp_hpad(hist_h)
    assert hpad == planes.shape[1]
    want = np.asarray(jwp.band_ok_mask(jnp.asarray(by),
                                       jnp.asarray(in_bounds), hpad))
    got = warp.band_ok_mask(torch.from_numpy(by),
                            torch.from_numpy(in_bounds), hpad).numpy()
    assert (got == want).all()
    assert want.any()
    assert (in_bounds & ~want).any() == (hist_h > 64)


def _cameras(orbit: bool):
    """(cur view·proj, prev view·proj) of a 64² viewport at (0, 0, 3), the
    current one after orbit([0,0,0], 6, 4) or unmoved; the port's camera
    must give the same matrices."""
    vps = []
    for cls in (JEditorCamera, EditorCamera):
        cam = cls()
        cam.set_viewport_size(64, 64)
        cam.set_position([0, 0, 3])
        cam.look_at_target([0, 0, 0])
        prev = (np.asarray(cam.proj) @ np.asarray(cam.view)).astype(np.float32)
        if orbit:
            cam.orbit([0, 0, 0], 6.0, 4.0)
        cur = (np.asarray(cam.proj) @ np.asarray(cam.view)).astype(np.float32)
        vps.append((cur, prev))
    (jc, jp), (pc, pp) = vps
    assert (jc == pc).all() and (jp == pp).all()
    return jc, jp


@pytest.mark.parametrize("orbit", [False, True], ids=["static", "orbit"])
def test_warp_from_blocks_matches_jax(orbit):
    """test_upscaler.py's two MXU-warp scenes (:392, :423): a 32×32 uint8
    history, half-res depth with some background, a static camera or
    orbit(6, 4). Pixels where the outputs differ must have px·0.5 − 0.5
    or py·0.5 − 0.5 within 1e-4 of a rounding boundary, and be < 0.5%
    (0 of 1024 measured in either scene)."""
    cur_vp, prev_vp = _cameras(orbit)
    rng = np.random.default_rng(22 if orbit else 21)
    blocks = rng.integers(0, 256, (32, 32, 12)).astype(np.uint8)
    depth = rng.uniform(0.2, 0.9, (32, 32)).astype(np.float32)
    depth[0, :4] = 1.0                     # background → invalid
    inv = np.linalg.inv(cur_vp).astype(np.float32)
    with kernel_knobs.overrides(warp_mxu=True):
        want = np.asarray(jup.warp_from_blocks(
            jnp.asarray(blocks), jnp.asarray(depth), jnp.asarray(inv),
            jnp.asarray(prev_vp), 64, 64))
    t = [torch.from_numpy(a) for a in (blocks, depth, inv, prev_vp)]
    got = up.warp_from_blocks(*t, 64, 64).numpy()
    assert got.shape == want.shape == (32, 32, 13)
    px, py, _pw = up._reproject_half(t[1], t[2], t[3], 64, 64)

    def near_boundary(v):
        v = v.numpy().astype(np.float64) * 0.5 - 0.5
        return np.abs(v - np.floor(v) - 0.5) < 1e-4

    differ = (got != want).any(-1)
    assert not (differ & ~(near_boundary(px) | near_boundary(py))).any()
    assert differ.mean() < 0.005
    valid = want[..., 12] == 1.0         # 1,020 static, 76 after the orbit
    assert valid.any() and (~valid).any()
