"""The upscaled field (`field1m_1080.ai`) on the CPU at 128² (rendered at
64²) with a 4² field and a net of seeded random weights, every conv drawn,
the head too: the program's frames against the plain reference, stage by
stage, from the state each was given; planted faults come out not
correct; the upscale stage's work; and what the reference loads."""

import copy

import numpy as np
import pytest
import torch

from benchmark import check, control, harness, upscale_work
from benchmark.test_benchmark_given import SteppedClock
from benchmark.test_benchmark_imports import loaded_after

CELL = "field1m_1080.ai"
SEED = 4102444800
SIZE = 128


def write_weights(path, seed: int = 7) -> str:
    """A 16 → 32 → 32 → 32 → 12 net of seeded normal weights in the shipped
    archive's layout, each conv's scale near the shipped one's; returns
    the path."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i, (cin, cout, scale) in enumerate([(16, 32, 0.09), (32, 32, 0.06),
                                            (32, 32, 0.06), (32, 12, 0.01)]):
        arrays[f"Conv_{i}/kernel"] = (scale * rng.standard_normal(
            (3, 3, cin, cout))).astype(np.float32)
        arrays[f"Conv_{i}/bias"] = (0.02 * rng.standard_normal(cout)).astype(
            np.float32)
    arrays.update(base_channels=np.asarray(32), scale=np.asarray(2),
                  in_channels=np.asarray(16))
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture
def small(tmp_path):
    """The cell's configuration at SIZE² with a 4² field, the camera pulled
    in to match, and the seeded net; `kernel` sets kernel knobs."""
    weights = write_weights(tmp_path / "upscaler.npz")

    def make(kernel=None) -> dict:
        _c, cfg, _t = harness.cell(CELL)
        cfg = copy.deepcopy(cfg)
        cfg.update(width=SIZE, height=SIZE, grid=4, upscaler=weights,
                   kernel=kernel)
        cfg["camera"]["position"] = [0.0, 0.0, 4 * 1.1 + 2.0]
        return cfg

    return make


@pytest.fixture
def stepped(monkeypatch):
    """The harness's clock stepping 10 ms a reading (a window of 0.15 s
    holds about 15 frames however busy the CPU is), its samples drawn
    among the first 8."""
    monkeypatch.setattr(harness, "SAMPLE_SPAN", 8)
    monkeypatch.setattr(harness, "time", SteppedClock())


def run(cfg, hook=None) -> dict:
    return harness.run_cell(CELL, SEED, 0.15, False, "cpu", hook=hook,
                            config=cfg)


def values(out: dict) -> dict:
    return {n: c["value"] for n, c in out["checks"].items()}


def test_frames_2_to_4_match_the_reference_stage_by_stage(small, tmp_path):
    cfg = small()
    cls = harness.scene_class(cfg)
    scene = cls(cfg, SEED, 240, torch.device("cpu"), str(tmp_path))
    frames, prev = [], None
    try:
        for k in range(5):
            scene.step(k)
            out = scene.renderer.draw_frame()
            kept = scene.kept(k)
            assert kept["colour"] is out.net_color
            assert kept["blocks"] is out.history
            assert torch.equal(kept["depth"].repeat_interleave(2, 0)
                               .repeat_interleave(2, 1), out.depth)
            if k >= 2:
                frames.append(check.Kept(k, out.color, kept,
                                         scene.given(prev)))
            prev = out
    finally:
        scene.close()
    nums = check.compare(cls, cfg, scene.motion, frames, "cpu")
    ok, checks = check.verdict(nums, cfg["limits"])
    assert ok, checks
    assert {"colour_err", "depth_err", "blocks_err",
            "blocks_diff_share"} <= set(nums)
    assert nums["mean_err"] > 0.0


def test_a_sound_run_is_correct(small, stepped):
    out = run(small())
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == {"off3_share", "mean_err",
                                  "blocks_diff_share"}


def history_ignored(scene, loop):
    """Every frame renders as if it had no history to warp."""
    step = scene.step

    def stepped(k):
        step(k)
        scene.renderer.prev_state = None

    scene.step = stepped


def history_two_frames_old(scene, loop):
    """Every frame warps the history of the frame two before it."""
    step, states = scene.step, []

    def stepped(k):
        step(k)
        r = scene.renderer
        states.append(r.prev_state)
        if len(states) >= 2:
            r.prev_state = states[-2]

    scene.step = stepped


@pytest.mark.parametrize("fault", [history_ignored, history_two_frames_old])
def test_a_frame_that_mistakes_its_history_is_not_correct(small, stepped,
                                                          fault):
    out = run(small(), fault)
    assert not out["correct"], out["checks"]


def test_a_bf16_net_fails_its_blocks_but_not_the_display_frame(small,
                                                               stepped):
    cfg = small(kernel={"upscale_dtype": "bf16"})
    out = run(cfg)
    nums = values(out)
    assert not out["correct"], out["checks"]
    limits = cfg["limits"]
    assert nums["blocks_diff_share"] > limits["blocks_diff_share"]
    display = {n: limits[n] for n in ("off3_share", "mean_err")}
    assert check.verdict(nums, display)[0], out["checks"]


def test_the_tf32_control_is_not_correct(small, stepped):
    cfg = small()
    nums = control.control_numbers(CELL, SEED, "cpu", config=cfg,
                                   seconds=0.15)
    assert not check.verdict(nums, cfg["limits"])[0], nums


def test_a_program_without_the_nets_colour_fails_at_construction(
        small, monkeypatch, tmp_path):
    from typing import NamedTuple

    from trident_tpu_torch.render import types

    class Older(NamedTuple):
        color: torch.Tensor
        history: torch.Tensor = None

    monkeypatch.setattr(types, "FrameOutput", Older)
    cfg = small()
    with pytest.raises(RuntimeError, match="net_color"):
        harness.scene_class(cfg)(cfg, SEED, 240, torch.device("cpu"),
                                 str(tmp_path))


def test_the_upscale_stages_work_is_the_hand_count():
    _c, cfg, _t = harness.cell(CELL)
    w = upscale_work.upscale_work(cfg)
    px = 960 * 540
    assert w.ops == 2 * 9 * px * (16 * 32 + 32 * 32 + 32 * 32 + 32 * 12)
    assert w.ops == 27_471_052_800
    assert w.bytes == px * (16 * 4 + 12 + 4 * 4)
    assert w.least_ms() == pytest.approx(w.ops / 67e12 * 1e3)


def test_the_reference_loads_nothing_of_either_package():
    names = loaded_after("import benchmark.reference.upscaled_field, "
                         "benchmark.upscale_work")
    assert not names & {"trident_tpu_torch", "trident_tpu", "jax", "jaxlib",
                        "flax"}
