"""The plain reference against the port's CPU frame at 128², its control
(the reference in TF32) against it, and the pieces of the reference."""

import numpy as np
import pytest
import torch

from benchmark import check, control, harness
from benchmark.reference import raster, transforms

SCENES = ("field1m_1080.dynamic", "crowd144_1080.animated")


@pytest.mark.parametrize("cell", SCENES)
def test_port_frame_matches_the_reference_within_the_limits(cell, small,
                                                            tmp_path):
    cfg = small(cell)
    cls = harness.scene_class(cfg)
    scene = cls(cfg, 20260, 240, torch.device("cpu"), str(tmp_path))
    try:
        for k in range(3):
            scene.step(k)
        out = scene.renderer.draw_frame()
        frames = [(2, out.color, scene.kept(2))]
    finally:
        scene.close()
    nums = check.compare(cls, cfg, scene.motion, frames, "cpu")
    ok, checks = check.verdict(nums, cfg["limits"])
    assert ok, checks
    assert nums["off3_share"] < 0.01 and nums["tile_err"] < 4.0


@pytest.mark.parametrize("cell", SCENES)
def test_control_fails_the_limits(cell):
    """The control: the reference computed in TF32 in the program's
    place comes out not correct. At the configuration's own scene
    (every sphere, every tube at its published sizes) on a 640×360
    frame: the reference alone, a few seconds on the CPU."""
    _c, cfg, _t = harness.cell(cell)
    cfg = dict(cfg, width=640, height=360)
    nums = control.control_numbers(cell, 20260, "cpu", config=cfg)
    ok, checks = check.verdict(nums, cfg["limits"])
    assert not ok, checks


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9])
    got = raster.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, 1.0, -3.0 - 2 ** -9]


def test_a_front_facing_square_covers_its_pixel_centres():
    """Two triangles over x, y in [−0.5, 0.5] of NDC at w = 1 cover the
    middle half of an 8 × 8 frame, each pixel once."""
    clip = torch.tensor([[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0],
                         [0.5, 0.5, 0.5, 1.0], [-0.5, 0.5, 0.5, 1.0]])
    tris = torch.tensor([[0, 1, 2], [0, 2, 3]])
    vis = raster.visibility(clip, tris, 8, 8)
    cov = (vis.tri >= 0).int()
    assert cov.sum() == 16 and cov[2:6, 2:6].all()
    assert torch.allclose(vis.depth[cov.bool()], torch.tensor(0.5))
    # the other winding faces away
    assert (raster.visibility(clip, tris.flip(1), 8, 8).tri < 0).all()


def test_mip_chain_box_filters():
    img = np.zeros((4, 4, 4), np.uint8)
    img[0, 0] = 255
    chain = raster.mip_chain(img)
    assert [m.shape[0] for m in chain] == [4, 2, 1]
    assert chain[1][0, 0, 0] == 64 and chain[2][0, 0, 0] == 16


def test_camera_matrices_follow_glm():
    v = transforms.look_at([0, 0, 5], [0, 0, 0])
    assert np.allclose(v @ [0, 0, 0, 1], [0, 0, -5, 1])
    p = transforms.perspective(90.0, 1.0, 1.0, 10.0)
    near = p @ [0, 0, -1, 1]
    far = p @ [0, 0, -10, 1]
    assert near[2] / near[3] == pytest.approx(0.0)
    assert far[2] / far[3] == pytest.approx(1.0)
    assert (p @ [0, 1, -1, 1])[1] < 0          # Vulkan's rows run down
    m = transforms.trs([1, 2, 3], [0, 90, 0], [2, 2, 2])
    assert np.allclose(m[0] @ [1, 0, 0, 1], [1, 2, 1, 1])
