"""The port's `flavor_pallas_forward` frame against the JAX package's PNG
golden, tests/goldens/flavor_pallas_forward.png (test_golden_flavors.py:
the `_base` scene at 128² on the Pallas path with forward shading and a
128² hard shadow map; the JAX Renderer runs it with its zskip and zorder
knobs, which skip and order work but change no pixel, and the port runs
neither). The gate is test_golden_flavors.py's: fewer than 0.2% of the
RGBA8 values off by more than 3 LSB, mean absolute difference below 0.35.
The PNG is read here with the JAX package's loader; the port never reads
PNGs. The same scene's op-by-op JAX frame is committed as
tests/goldens/torch_slice_pallas_forward.npy for chip_smoke.py.
"""

import pathlib

import torch

from trident_tpu.io.image import load_rgba8

from trident_tpu_torch.tools_dev.scenes import feature_scene

from test_torch_frame import _assert_golden_gate, check_feature_frame

torch.set_num_threads(1)

GOLDEN = (pathlib.Path(__file__).resolve().parent / "goldens"
          / "flavor_pallas_forward.png")


def test_pallas_forward_frame_passes_the_png_golden():
    r = feature_scene("pallas_forward", "cpu")
    assert r.config.render.shadows and r.config.render.shadow_map_size == 128
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0] and out.shadow_aux.tolist() == [0, 0]
    golden = load_rgba8(str(GOLDEN))
    assert golden.shape == (128, 128, 4)
    _assert_golden_gate(r.read_frame(out), golden)
    # the frame is the scene: the cube and the ground cover it, and the
    # sun's shadow darkens some of the ground
    assert int((out.tri_id >= 0).sum()) > 5000


def test_pallas_forward_reference_is_the_jax_frame(tmp_path):
    """The committed torch_slice_pallas_forward.npy is the JAX package's
    op-by-op frame of the scene, and the port's frame is within the gate of
    it (equal triangle ids, aux [0, 0])."""
    _r, out, _jcolor = check_feature_frame("pallas_forward", tmp_path)
    assert out.shadow_aux.tolist() == [0, 0]
