"""A frame that takes in state from the frame before it, as the 2×
upscaled frame warps in its predecessor's history, is judged one step at a
time: the reference renders each compared step from the state that the
program's frame was given. A stub scene, defined here, stands for such a
frame at 128² on the CPU: each frame blends a pattern of its own step half
and half with its predecessor's output. Also here: what that leaves as it
was for the two configurations, whose frames take in nothing."""

from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from benchmark import check, control, harness, work
from benchmark.conftest import small_config
from benchmark.loops import takes_given
from benchmark.reference import raster
from benchmark.scenes import common

DRAW_CELL = "field1m_1080.dynamic"     # cells whose configuration the stub's
ROWS_CELL = "field1m_1080.offline"     # replaces: the draw and rows loops
SEED = 31415926535
SIZE = 128
STUB_CFG = {"name": "stub", "scene": "stub", "width": SIZE, "height": SIZE,
            "limits": {"off3_share": 0.01, "mean_err": 0.5}}
CONFIG_CELLS = ("field1m_1080.dynamic", "crowd144_1080.animated")


def pattern(motion, k: int, control: bool = False) -> torch.Tensor:
    """(SIZE, SIZE, 4) f32: the fraction of a plane over the pixel grid,
    moved by the traffic's shift at step k. Its offsets lie near 1024, so
    TF32 (the control) keeps none of their fraction."""
    shift = float(motion[k % len(motion)])
    ys, xs = torch.meshgrid(torch.arange(SIZE, dtype=torch.float32),
                            torch.arange(SIZE, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], -1).view(-1, 3)
    plane = torch.tensor([[0.37, 0.11, 0.23], [0.05, 0.29, 0.41],
                          [1024.0, 1024.5, 1024.25]]) + torch.tensor(
        [[0.0], [0.0], [shift]])
    rgb = torch.remainder(raster.matmul(grid, plane, control), 1.0)
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], 1).view(
        SIZE, SIZE, 4)


def blend(img: torch.Tensor, history: Optional[torch.Tensor]):
    """The RGBA8 frame: `img` half and half with the history, if any."""
    if history is not None:
        img = 0.5 * img + 0.5 * (history.float() / 255.0)
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


class StubReference:
    """The stub's plain reference: step k from the given history."""

    @staticmethod
    def reference_frame(cfg, motion, k, device, control=False, given=None):
        given = given or {}
        return {"color": blend(pattern(motion, k, control),
                               given.get("history"))}


class StubOut(NamedTuple):
    color: torch.Tensor
    history: torch.Tensor
    step: int
    aux: torch.Tensor
    shadow_aux: Optional[torch.Tensor] = None


class StubRenderer:
    """The program's side: draws the scene's step blended with the
    history of the frame `lag` frames back, or with none."""

    graphs = None

    def __init__(self, scene) -> None:
        self.scene = scene
        self.max_inflight = 1
        self.lag, self.use_history = 1, True
        self.histories: list = []

    def draw_frame(self) -> StubOut:
        k = self.scene.k
        hist = (self.histories[-self.lag] if self.use_history
                and len(self.histories) >= self.lag else None)
        color = blend(pattern(self.scene.motion, k), hist)
        self.histories = (self.histories + [color])[-2:]
        return StubOut(color, color, k, torch.zeros(2, dtype=torch.int32))


class StubScene:
    reference = StubReference

    @staticmethod
    def motion_of(cfg, seed, cycle):
        return np.random.default_rng([seed, 7]).random(cycle)

    def __init__(self, cfg, seed, cycle, device, workdir) -> None:
        self.motion = self.motion_of(cfg, seed, cycle)
        self.k = 0
        self.renderer = StubRenderer(self)

    def step(self, k: int) -> None:
        self.k = k

    def kept(self, k: int) -> dict:
        return {}

    def given(self, prev_out: StubOut) -> dict:
        return {"history": prev_out.history, "step": prev_out.step}

    def close(self) -> None:
        pass

    def span_targets(self) -> list:
        return []


class SteppedClock:
    """A host clock that moves 10 ms at each reading."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.01
        return self.now


@pytest.fixture
def stub(monkeypatch):
    """The stub scene in place of the configurations' scenes, the
    harness's clock stepping 10 ms a reading (a window of 0.3 s holds
    about 30 frames however busy the CPU is, its samples drawn among the
    first 8); the reference's calls recorded as (step, control, given)."""
    calls = []
    monkeypatch.setattr(harness, "scene_class", lambda cfg: StubScene)
    monkeypatch.setattr(harness, "SAMPLE_SPAN", 8)
    monkeypatch.setattr(harness, "time", SteppedClock())
    frame = StubReference.reference_frame

    def recorded(cfg, motion, k, device, control=False, given=None):
        calls.append((k, control, given))
        return frame(cfg, motion, k, device, control, given)

    monkeypatch.setattr(StubReference, "reference_frame",
                        staticmethod(recorded))
    return calls


def run(cell=DRAW_CELL, hook=None):
    return harness.run_cell(cell, SEED, 0.3, False, "cpu", hook=hook,
                            config=STUB_CFG)


def history_ignored(scene, loop):
    scene.renderer.use_history = False


def history_two_frames_old(scene, loop):
    scene.renderer.lag = 2


def test_a_sound_run_is_correct(stub):
    out = run()
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", [history_ignored, history_two_frames_old])
def test_a_frame_that_mistakes_its_history_is_not_correct(stub, fault):
    out = run(hook=fault)
    assert not out["correct"], out["checks"]


def test_each_frame_is_compared_with_its_own_given_state(stub):
    out = run()
    assert len(stub) == harness.SAMPLES + 1
    for k, ctl, given in stub:
        assert not ctl and given["step"] == k - 1
    last = harness.WARMUP + out["attempted"] - 1
    assert stub[-1][0] == last and stub[-1][2]["step"] == last - 1


def test_packed_rows_refuse_given_state(stub):
    scenes = []
    with pytest.raises(ValueError, match="packed rows cannot carry"):
        run(ROWS_CELL, hook=lambda scene, loop: scenes.append(scene))
    assert scenes and scenes[0].renderer.histories == []


def test_the_control_steps_from_the_programs_given_state(stub):
    """The TF32 step and the float32 step of each compared frame are
    given the same state, the state one run of the program gave it."""
    nums = control.control_numbers(DRAW_CELL, SEED, "cpu", config=STUB_CFG,
                                   seconds=0.3)
    ok, checks = check.verdict(nums, STUB_CFG["limits"])
    assert not ok, checks
    assert len(stub) == 2 * (harness.SAMPLES + 1)
    for (k, ctl, given), (k2, ctl2, given2) in zip(stub[::2], stub[1::2]):
        assert (k, ctl, k2, ctl2) == (k, False, k, True)
        assert given2 is given and given["step"] == k - 1


@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_no_given_state_reads_as_an_empty_one(cell, tmp_path):
    cfg = small_config(cell)
    cls = harness.scene_class(cfg)
    assert not takes_given(cls)
    scene = cls(cfg, 4242, 240, torch.device("cpu"), str(tmp_path))
    try:
        for k in range(3):
            scene.step(k)
        out = scene.renderer.draw_frame()
        frame = (2, out.color, scene.kept(2))
    finally:
        scene.close()
    bare = check.compare(cls, cfg, scene.motion, [frame], "cpu")
    empty = check.compare(cls, cfg, scene.motion,
                          [check.Kept(*frame, given={})], "cpu")
    assert bare == empty and bare["mean_err"] > 0.0


@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_raster_work_is_counted_at_the_winner_maps_size(cell):
    """For the configurations the winner map is the configuration's own
    size, so the count is the one made at width × height (a frame of
    unequal sides, so that the two cannot be swapped unseen)."""
    cfg = dict(small_config(cell), width=160, height=96)
    cls = harness.scene_class(cfg)
    _c, _cfg, traffic = harness.cell(cell)
    traced = [3, 4, 5, 6]
    got = harness._raster_work(cls, cfg, 77, traffic, traced, "cpu")
    motion = cls.motion_of(cfg, 77, traffic["cycle"])
    counts = []
    for k in traced:
        ref = cls.reference.reference_frame(cfg, motion, k, "cpu")
        assert tuple(ref["tri"].shape) == (96, 160)
        counts.append(work.raster_work(ref["mesh"], ref["tri"], 160, 96))
    want = work.RasterWork(*[float(np.mean([getattr(c, f) for c in counts]))
                             for f in work.RasterWork._fields])
    assert got == want and got.pairs > 0


def test_absent_render_keys_give_todays_render_config():
    from trident_tpu_torch.core.config import RenderConfig

    for cell in CONFIG_CELLS:
        _c, cfg, _t = harness.cell(cell)
        assert common.render_config(cfg) == RenderConfig(
            width=cfg["width"], height=cfg["height"],
            clear_color=tuple(cfg["clear_color"]), shadows=cfg["shadows"],
            kernel=cfg["kernel"])
    _c, cfg, _t = harness.cell(CONFIG_CELLS[0])
    named = dict(cfg, ai_upscale=True, shadow_map_size=2048, shadow_pcf=True,
                 bloom=True)
    rc = common.render_config(named)
    assert (rc.ai_upscale, rc.shadow_map_size, rc.shadow_pcf, rc.bloom) == (
        True, 2048, True, True)
    assert rc == RenderConfig(**{**common.render_config(cfg).__dict__,
                                 "ai_upscale": True, "shadow_map_size": 2048,
                                 "shadow_pcf": True, "bloom": True})


@pytest.mark.parametrize("cast", [None, False, True])
def test_the_light_casts_shadows_where_the_configuration_says(cast):
    from trident_tpu_torch.ecs.components import LightComponent
    from trident_tpu_torch.ecs.registry import Registry

    _c, cfg, _t = harness.cell(CONFIG_CELLS[0])
    if cast is not None:
        cfg = dict(cfg, light=dict(cfg["light"], cast_shadows=cast))
    reg = Registry()
    common.light(reg, cfg)
    (_e, (light,)), = list(reg.view(LightComponent))
    assert light.cast_shadows is bool(cast)
