"""The interpolation trainer's data path on trident_tpu_torch against the
JAX package, on the CPU: ai/dataset.py (list_frames, load_frame,
TripletDataset) and io/dataset_recorder.py.

load_frame decodes PNG with the port's io/image.py and resizes as PIL's
Image.BILINEAR does (ai/dataset.py::resize_bilinear_pil), where the JAX
loader calls PIL: at upscale and downscale sizes every value is within
1/255 of the JAX loader's and at least 99% are equal (all are, measured).
Anything but PNG raises ValueError. TripletDataset's samples, wrap-padded
batches and split equal the JAX ones; the recorder writes the same bytes.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from trident_tpu.ai import dataset as jds
from trident_tpu.io.dataset_recorder import FrameDatasetRecorder as JRecorder

from trident_tpu_torch.ai import dataset as pds
from trident_tpu_torch.io.dataset_recorder import FrameDatasetRecorder

torch.set_num_threads(1)

EQUAL_SHARE = 0.99


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Seven 40×56 PNG frames of mixed kinds (RGB, RGBA, grey, palette)."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    for i in range(7):
        rgb = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
        img = Image.fromarray(rgb)
        img = {0: img, 1: img.convert("RGBA"), 2: img.convert("L"),
               3: img.convert("P")}[i % 4]
        img.save(d / f"frame_{i:03d}.png")
    return d


@pytest.mark.parametrize("resolution", [(16, 24), (40, 56), (64, 96),
                                        (29, 70)])
def test_load_frame_matches_the_pil_loader(frames, resolution):
    for path in pds.list_frames(str(frames)):
        want = jds.load_frame(path, resolution)
        got = pds.load_frame(path, resolution)
        assert got.dtype == np.float32 and got.shape == (*resolution, 3)
        assert np.abs(got - want).max() <= 1 / 255 + 1e-7
        assert (got == want).mean() >= EQUAL_SHARE


@pytest.mark.parametrize("src,dst", [((540, 960), (256, 256)),
                                     ((7, 5), (7, 9)), ((33, 17), (20, 30))])
def test_resize_equals_pil_bilinear(src, dst):
    img = (np.random.default_rng(sum(src)).random((*src, 3)) * 255) \
        .astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(pds.resize_bilinear_pil(img, *dst), want)


def test_list_frames_and_triplets_match_jax(frames, tmp_path):
    assert pds.list_frames(str(frames)) == jds.list_frames(str(frames))
    pattern = str(frames / "frame_00[1-5].png")
    assert pds.list_frames(pattern) == jds.list_frames(pattern)
    res = (24, 32)
    got, want = pds.TripletDataset(str(frames), res), \
        jds.TripletDataset(str(frames), res)
    assert len(got) == len(want) == 5
    for k in range(len(want)):
        for a, b in zip(got.sample(k), want.sample(k)):
            np.testing.assert_array_equal(a, b)
    for frac, seed in ((0.1, 42), (0.4, 7)):
        assert got.split(frac, seed) == want.split(frac, seed)
    order = np.random.default_rng(0).permutation(5)
    for bs in (2, 3, 5):
        pairs = list(zip(got.batches(order, bs), want.batches(order, bs)))
        assert len(pairs) == -(-5 // bs)
        for (gi, gt), (wi, wt) in pairs:
            assert gi.shape == (bs, *res, 6)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
    os.makedirs(tmp_path / "two")
    for i in range(2):
        Image.new("RGB", (8, 8)).save(tmp_path / "two" / f"f{i}.png")
    with pytest.raises(ValueError, match="need ≥3 frames"):
        pds.TripletDataset(str(tmp_path / "two"))


def test_non_png_frames_raise(tmp_path):
    """The JAX loader reads any format PIL reads; the port reads PNG only
    (queue 3 divergence, as load_rgba8)."""
    path = tmp_path / "frame.bmp"
    Image.new("RGB", (8, 8), (10, 20, 30)).save(path)
    assert jds.load_frame(str(path), (8, 8)).shape == (8, 8, 3)
    with pytest.raises(ValueError):
        pds.load_frame(str(path), (8, 8))


def test_recorder_writes_the_same_bytes(tmp_path):
    rng = np.random.default_rng(9)
    frames = [rng.random((6, 10, 3)).astype(np.float32) for _ in range(3)]
    dirs = []
    for name, cls in (("jax", JRecorder), ("port", FrameDatasetRecorder)):
        rec = cls(str(tmp_path / name), interval_s=0.5)
        rec.start()
        for k, f in enumerate(frames):
            idx = rec.record_input_frame(f, now=float(k))
            assert idx == k
            rec.record_ai_output(idx, f * 0.5)
        assert rec.record_input_frame(frames[0], now=2.2) is None  # throttled
        rec.stop()
        assert not rec.running and rec.written_count == 6
        dirs.append(tmp_path / name)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == 12
    for n in names:
        assert (dirs[0] / n).read_bytes() == (dirs[1] / n).read_bytes(), n
