"""File mip chains on the port: TextureSlots.device_arrays with author
mip levels against the JAX package's (trident_tpu/render/textures.py:
84-180), bit for bit; `replace` and `lookup`; and a frame whose texture
carries a file chain against the JAX frame.
"""

import numpy as np
import torch

from trident_tpu.render.textures import TextureSlots as JTextureSlots

from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.tools_dev.scenes import checker_mips

from test_torch_frame import check_feature_frame

torch.set_num_threads(1)


def _same_tables(js, ps):
    jt, pt = js.device_arrays(), ps.device_arrays("cpu")
    assert (pt.quads.numpy() == np.asarray(jt.quads).view(np.int32)).all()
    assert (pt.sizes.numpy() == np.asarray(jt.sizes)).all()
    assert int(pt.max_level) == int(jt.max_level)
    return pt


def _chains(rng):
    """(key, image, mips) cases: a full chain, a suffix, levels of the
    wrong size (ignored), float levels, a non-square image, an oversized
    image (downscaled to fit: the chain matches by size)."""
    def img(h, w):
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)

    return [
        ("full", img(64, 64), checker_mips(64)),
        ("suffix", img(32, 32), [img(4, 4), img(2, 2), img(1, 1)]),
        ("wrong", img(32, 32), [img(15, 15), img(8, 9)]),
        ("float", img(16, 16),
         [rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)]),
        ("oblong", img(16, 32), [img(8, 16), img(2, 4)]),
        ("big", img(128, 128), [img(32, 32), img(16, 16)]),
        ("plain", img(32, 32), None),
    ]


def test_device_arrays_with_file_mips_equal_jax():
    rng = np.random.default_rng(17)
    js, ps = JTextureSlots(edge=64), TextureSlots(edge=64)
    for key, image, mips in _chains(rng):
        assert js.acquire(key, image, mips=mips) == \
            ps.acquire(key, image, mips=mips)
    pt = _same_tables(js, ps)
    # the file levels are in the table: a chain differs from box filtering
    box = TextureSlots(edge=64)
    for key, image, _mips in _chains(np.random.default_rng(17)):
        box.acquire(key, image)
    assert (box.device_arrays("cpu").quads != pt.quads).any()
    assert ps.lookup("suffix") == js.lookup("suffix") == 2
    assert ps.lookup("missing") == js.lookup("missing") == 0


def test_replace_with_mips_equals_jax():
    rng = np.random.default_rng(23)
    js, ps = JTextureSlots(edge=64), TextureSlots(edge=64)
    for key, image, mips in _chains(rng)[:3]:
        js.acquire(key, image, mips=mips)
        ps.acquire(key, image, mips=mips)
    v = ps.version
    new = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    chain = checker_mips(32)
    assert ps.replace("full", new, mips=chain) == \
        js.replace("full", new, mips=chain) == 1
    assert ps.version == v + 1
    # a new key is a new slot, mips and all
    assert ps.replace("fresh", new, mips=chain) == \
        js.replace("fresh", new, mips=chain)
    _same_tables(js, ps)
    # and a replace without mips drops the chain
    js.replace("full", new)
    ps.replace("full", new)
    _same_tables(js, ps)


def test_renderer_acquire_texture_takes_mips():
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(device="cpu")
    slot = r.acquire_texture("m", np.zeros((8, 8, 4), np.uint8),
                             mips=checker_mips(8))
    assert slot == 1 and r.textures._mips[slot][0].shape == (4, 4, 4)


def test_mips_frame_matches_jax(tmp_path):
    """The `_base` scene with its checker given a flat-coloured file chain
    (tiling 4, so the cube samples levels below 0) against the JAX frame;
    the chain's colours show in it."""
    _r, out, _j = check_feature_frame("mips", tmp_path)
    covered = (out.tri_id >= 0).numpy()
    rgb = out.color.numpy()[covered][:, :3].astype(int)
    # saturated texels (the file levels) are on the cube, not only greys
    assert ((rgb.max(-1) - rgb.min(-1)) > 30).mean() > 0.05
