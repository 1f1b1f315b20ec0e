"""The port's text overlay and video encoder against the JAX package's, on
the CPU.

  * io/text_overlay.py: render_overlay pixel for pixel equal to the JAX
    TextOverlay (PIL, DejaVu Sans Mono) at sizes 12, 13, 16 and an odd
    sample of 8–48, over strings that hold every printable ASCII
    character in colours drawn from a seed, overlapping and clipped at
    the edges, multiline included; composite_overlay bit-equal; a size
    outside 8–48 raises; the committed atlas is what
    tools_dev/make_font_atlas.py builds, byte for byte;
  * with PIL blocked, the port's overlay, PNG writer and the viewer's
    frame_png still work (a child process);
  * io/video.py: the JAX and port encoders write byte-equal Y4M files for
    the same frames, odd sizes included; rgb_to_yuv420 bit-equal.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from trident_tpu.io import text_overlay as jto
from trident_tpu.io import video as jvideo

from trident_tpu_torch.io import text_overlay as to
from trident_tpu_torch.io import video

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRINTABLE = "".join(chr(c) for c in range(32, 127))


def text_items(size: int, seed: int, w: int, h: int):
    """Strings covering every printable character, at positions and in
    colours from a seed; some overlap, one runs off the left and top
    edges, one is multiline."""
    rng = np.random.default_rng(seed)
    chunk = max(8, (w - 4) * 64 // (size * 39))
    pieces = [PRINTABLE[i:i + chunk] for i in range(0, len(PRINTABLE), chunk)]
    items = []
    for k, text in enumerate(pieces):
        items.append((text, int(rng.integers(-2, 6)), 2 + k * (size + 3),
                      tuple(rng.uniform(0, 1, 4).round(3)), size))
    items.append(("edge\nof it", -size // 2, -size // 3,
                  (1.0, 0.5, 0.0, 1.0), size))
    items.append((PRINTABLE[::-1][:chunk], 3, 5, (0.2, 0.9, 0.4, 0.6), size))
    return items


def overlays(items, w, h):
    j, p = jto.TextOverlay(), to.TextOverlay()
    for ov in (j, p):
        for text, x, y, color, size in items:
            ov.queue_text(7, text, x, y, color, size)
    return j.render_overlay(7, w, h), p.render_overlay(7, w, h)


@pytest.mark.parametrize("size", [12, 13, 16, 8, 11, 21, 29, 37, 47])
def test_render_overlay_pixel_equal_to_jax(size):
    w, h = 8 * size + 40, 5 * size + 30
    want, got = overlays(text_items(size, size, w, h), w, h)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    assert (want[..., 3] > 0).sum() > 20 * size
    assert (got == want).all(), int((got != want).any(-1).sum())


def test_overlay_queue_semantics_and_size_range():
    ov = to.TextOverlay()
    assert ov.render_overlay(0, 8, 8) is None and not ov.has_text(0)
    ov.queue_text(0, "a", 0, 0)
    ov.queue_text(1, "b", 0, 0)
    assert ov.has_text(0) and ov.has_text(1)
    ov.clear_viewport(0)
    assert not ov.has_text(0) and ov.has_text(1)
    ov.begin_frame()
    assert not ov.has_text(1)
    for size in (7, 49, 0):
        with pytest.raises(ValueError, match="8-48"):
            ov.queue_text(0, "x", 0, 0, size=size)
    ov.queue_text(0, "", 0, 0)                     # nothing to draw
    assert not ov.render_overlay(0, 8, 8).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_overlay_bit_equal(seed):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)
    ov = rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)
    ov[..., 3][rng.random((33, 47)) < 0.3] = 0
    ov[..., 3][rng.random((33, 47)) < 0.2] = 255
    assert (to.composite_overlay(frame, ov)
            == jto.composite_overlay(frame, ov)).all()


def test_committed_atlas_is_the_generators_output(tmp_path):
    pytest.importorskip("PIL")
    from trident_tpu_torch.tools_dev import make_font_atlas as mfa

    if not os.path.isfile(mfa.FONT):
        pytest.skip("DejaVu Sans Mono is not installed")
    out = tmp_path / "atlas.npz"
    mfa.write_npz(str(out), mfa.build())
    assert out.read_bytes() == pathlib.Path(to.ATLAS_PATH).read_bytes()
    assert out.stat().st_size < 2 * 1024 * 1024
    assert (pathlib.Path(to.ATLAS_PATH).parent
            / "font_dejavu_sans_mono.copyright").is_file()


_NO_PIL = """
import sys
sys.modules["PIL"] = None
sys.modules["jax"] = None
sys.modules["trident_tpu"] = None
import numpy as np
from trident_tpu_torch.io.text_overlay import TextOverlay, composite_overlay
from trident_tpu_torch.io.image import encode_png, read_png, save_png
from trident_tpu_torch.scripts import viewer
ov = TextOverlay()
ov.queue_text(0, "no PIL here", 1, 1, (1, 1, 0, 1), 13)
img = ov.render_overlay(0, 90, 20)
assert img[..., 3].any()
save_png(sys.argv[1], img)
assert (read_png(sys.argv[1]) == img).all()

class Args:
    width, height, model, scene, shadows = 48, 32, [], None, False

app = viewer.build_app(Args, device="cpu")
srv = viewer.ViewerServer(app, "127.0.0.1", 0)
import threading
threading.Thread(target=srv.serve_forever, daemon=True).start()
png = srv.frame_png(1)
assert png[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
srv.shutdown()
app.shutdown()
assert "PIL.Image" not in sys.modules
print("ok without PIL")
"""


def test_overlay_png_and_viewer_frame_without_pil(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_PIL,
                           str(tmp_path / "t.png")], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok without PIL" in proc.stdout


def _encode(enc, path, frames, w, h):
    """Record `frames` one at a time (each encoded before the next is
    submitted, so the queue never fills and nothing drops)."""
    assert enc.begin_session(str(path), w, h, fps=24)
    for f in frames:
        assert enc.submit_frame(f)
        deadline = time.monotonic() + 30
        while enc.frames_encoded < enc.frames_submitted:
            assert time.monotonic() < deadline, "the encoder stalled"
            time.sleep(0.001)
    return enc.end_session()


@pytest.mark.parametrize("w,h", [(32, 20), (33, 21), (17, 40)])
def test_y4m_bytes_equal_to_jax(tmp_path, w, h):
    rng = np.random.default_rng(w * h)
    frames = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
              for _ in range(5)]
    frames.append(frames[0][..., :3].copy())        # an RGB frame too
    jp = _encode(jvideo.VideoEncoder(), tmp_path / "j.y4m", frames, w, h)
    pp = _encode(video.VideoEncoder(), tmp_path / "p.mkv", frames, w, h)
    assert pp.endswith("p.y4m") and jp.endswith("j.y4m")   # no ffmpeg path
    got, want = pathlib.Path(pp).read_bytes(), pathlib.Path(jp).read_bytes()
    ew, eh = w - w % 2, h - h % 2
    header = f"YUV4MPEG2 W{ew} H{eh} F24:1 Ip A1:1 C420\n".encode()
    assert got.startswith(header)
    assert len(got) == len(header) + 6 * (6 + ew * eh * 3 // 2)
    assert got == want


def test_encoder_session_rules():
    enc = video.VideoEncoder()
    assert not enc.submit_frame(np.zeros((4, 4, 3), np.uint8))
    assert not enc.begin_session("x.y4m", 1, 1)          # sizes < 2
    assert enc.end_session() is None and enc.frames_dropped == 0


@pytest.mark.parametrize("shape", [(6, 8, 3), (7, 9, 3), (2, 2, 4)])
def test_rgb_to_yuv420_bit_equal(shape):
    rgb = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    for a, b in zip(video.rgb_to_yuv420(rgb[..., :3]),
                    jvideo.rgb_to_yuv420(rgb[..., :3])):
        assert a.dtype == np.uint8 and (a == b).all()
