"""Post stages of the port (ops/post.py) against the JAX package's
trident_tpu/ops/post.py on seeded linear-HDR images.

Tolerances: bloom within 1e-6 absolute (its values are O(1–10)) — the JAX
blur is a conv_general_dilated whose XLA:CPU dot sums the 13 taps in
another order than the port's shifted-slice sum, an ulp or two; the
supersample resolve within 1e-6 on values in [0, 1] (a mean of f²
samples summed in another order). Factor 1 is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ops import post as jpost

from trident_tpu_torch.ops import post

torch.set_num_threads(1)


def _hdr(rng, h, w):
    """Linear HDR with highlights: a gamma-distributed base plus a few
    bright blobs well over any bloom threshold."""
    img = rng.gamma(0.6, 0.7, (h, w, 3)).astype(np.float32)
    for _ in range(4):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[max(0, y - 3):y + 3, max(0, x - 3):x + 3] += 6.0
    return img


@pytest.mark.parametrize("shape", [(128, 128), (130, 135), (64, 96)])
@pytest.mark.parametrize("threshold,strength", [(1.0, 0.6), (0.35, 0.8)])
def test_bloom_matches_jax(shape, threshold, strength):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    hdr = _hdr(rng, *shape)
    with jax.disable_jit():
        want = np.asarray(jpost.bloom(jnp.asarray(hdr), threshold, strength))
    got = post.bloom(torch.from_numpy(hdr), threshold, strength).numpy()
    assert got.shape == want.shape == hdr.shape
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - hdr).max() > 0.05          # the highlights bloomed
    # the edge rows/columns past the last whole 4×4 block copy the last one
    if shape[0] % 4:
        bloom_add = got - hdr
        h4 = shape[0] // 4 * 4
        np.testing.assert_allclose(bloom_add[h4:], np.broadcast_to(
            bloom_add[h4 - 1:h4], bloom_add[h4:].shape), atol=1e-6)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_resolve_supersample_matches_jax(factor):
    rng = np.random.default_rng(factor)
    img = rng.uniform(0.0, 1.0, (48 * factor, 40 * factor, 4)).astype(
        np.float32)
    want = np.asarray(jpost.resolve_supersample(jnp.asarray(img), factor))
    got = post.resolve_supersample(torch.from_numpy(img), factor).numpy()
    assert got.shape == want.shape == (48, 40, 4)
    assert np.abs(got - want).max() <= 1e-6
    if factor == 1:
        assert (got == img).all()
