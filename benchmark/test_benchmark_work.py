"""The raster work the roofline is counted from, against the program's
own count of the same rule (tools_dev/kbench.py::bbox_pixel_pairs, what
chip_smoke.py's vis_work counts operations from) and the port's winners,
on a small scene on the CPU."""

import pytest
import torch

from benchmark import harness, work


@pytest.mark.parametrize("cell", ["field1m_1080.dynamic",
                                  "crowd144_1080.animated"])
def test_pairs_and_winners_match_the_programs_count(cell, small, tmp_path):
    from trident_tpu_torch.ops import raster as program_raster
    from trident_tpu_torch.render.renderer import frame_geometry
    from trident_tpu_torch.tools_dev.kbench import bbox_pixel_pairs

    cfg = small(cell, 256)
    cls = harness.scene_class(cfg)
    scene = cls(cfg, 99, 240, torch.device("cpu"), str(tmp_path))
    try:
        for k in range(2):
            scene.step(k)
        out = scene.renderer.draw_frame()
        inp = scene.renderer.frame_inputs()
    finally:
        scene.close()
    w, h = cfg["width"], cfg["height"]
    cs, _records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp.get("draw_stride", 0),
        real_draws=inp.get("real_draws", 0),
        vertex_colors=inp["vertex_colors"], geometry=inp["geometry"],
        palette=inp["palette"], skinned=inp["skinned"])
    bins = program_raster.build_bins(cs.setup, w, h,
                                     setup_cols=cs.cols.setup)
    ntx = -(-w // program_raster.TILE)
    theirs = bbox_pixel_pairs(bins, cs.setup, ntx)

    ref = cls.reference.reference_frame(cfg, scene.motion, 1, "cpu")
    ours = work.raster_work(ref["mesh"], ref["tri"], w, h)
    # kbench takes each vertex from two edge rows' cross product, which
    # for triangles of about a pixel is ill-conditioned, and sums per hit
    # sub-block and tile; the count here projects the vertices directly
    assert ours.pairs == pytest.approx(theirs, rel=0.05)
    assert ours.ops == ours.pairs * work.OPS_PER_PAIR
    port_winners = int(torch.unique(out.tri_id[out.tri_id >= 0]).numel())
    assert ours.winners == pytest.approx(port_winners, rel=0.01)
    assert ours.in_view <= int(cs.setup.valid.sum())


def test_least_time_is_the_larger_bound():
    w = work.RasterWork(1, 1, 1, ops=67e12 * 2e-3, bytes=3.35e12 * 1e-3)
    assert w.least_ms() == pytest.approx(2.0)
    w = work.RasterWork(1, 1, 1, ops=0.0, bytes=3.35e12 * 1e-3)
    assert w.least_ms() == pytest.approx(1.0)
