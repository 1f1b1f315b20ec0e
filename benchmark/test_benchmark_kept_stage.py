"""A frame judged stage by stage, each stage on the program's own input:
the scene keeps a stage's output, and the reference computes the next
stage from it. A two-stage stub scene, defined here, stands for the
upscaled field at 128² on the CPU: stage A shades a pattern (the field's
half-size colour), stage B runs a seeded three-conv net over A's output
and the history the frame was given, quantized to uint8 as the next
history (the upscaler's blocks); the display frame is B's RGBA8. A net in
bf16 leaves the display frame inside its limits and fails B's numbers.
Also here: what the kept-stage path leaves as it was for the two
configurations, whose references take nothing the program kept."""

from typing import Optional

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import check, control, harness
from benchmark.conftest import small_config
from benchmark.reference import raster
from benchmark.test_benchmark_given import SteppedClock, StubOut

CELL = "field1m_1080.dynamic"      # the cell whose configuration it replaces
SEED = 27182818284
SIZE = 128
WIDTH = 16                         # the net's hidden channels
DISPLAY_LIMITS = {"off3_share": 0.01, "mean_err": 0.5}
STUB_CFG = {"name": "stub", "scene": "stub", "width": SIZE, "height": SIZE,
            "limits": dict(DISPLAY_LIMITS, shaded_err=1e-4,
                           blocks_diff_share=0.002)}
CONFIG_CELLS = ("field1m_1080.dynamic", "crowd144_1080.animated")


def shaded(motion, k: int, control: bool = False) -> torch.Tensor:
    """Stage A, (SIZE, SIZE, 3) f32: the fraction of a plane over the
    pixel grid, moved by the traffic's shift at step k. Its offsets lie
    near 1024, so TF32 (the control) keeps none of their fraction."""
    shift = float(motion[k % len(motion)])
    ys, xs = torch.meshgrid(torch.arange(SIZE, dtype=torch.float32),
                            torch.arange(SIZE, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], -1).view(-1, 3)
    plane = torch.tensor([[0.0137, 0.0071, 0.0093], [0.0049, 0.0119, 0.0061],
                          [1024.0, 1024.5, 1024.25]]) + torch.tensor(
        [[0.0], [0.0], [shift]])
    return torch.remainder(raster.matmul(grid, plane, control),
                           1.0).view(SIZE, SIZE, 3)


def net_params() -> list:
    """The net's seeded (weight, bias) pairs: 6 → WIDTH → WIDTH → 3."""
    g = torch.Generator().manual_seed(1234)
    shapes = [(WIDTH, 6), (WIDTH, WIDTH), (3, WIDTH)]
    return [(torch.randn((o, i, 3, 3), generator=g) / (3.0 * i ** 0.5),
             0.05 * torch.randn((o,), generator=g)) for o, i in shapes]


PARAMS = net_params()


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         precision: str) -> torch.Tensor:
    """A 3×3 conv in f32; in "tf32" its operands rounded to 10 mantissa
    bits, summed in f32 (the control); in "bf16" its operands and its
    output rounded to bf16, summed in f32 (a lower precision than the
    stub states)."""
    if precision == "tf32":
        x, w = raster.tf32(x), raster.tf32(w)
    elif precision == "bf16":
        x, w, b = (t.to(torch.bfloat16).float() for t in (x, w, b))
    y = F.conv2d(x, w, b, padding=1)
    return y.to(torch.bfloat16).float() if precision == "bf16" else y


def blocks(colour: torch.Tensor, history: Optional[torch.Tensor],
           precision: str = "f32") -> torch.Tensor:
    """Stage B, (SIZE, SIZE, 3) uint8: the net over stage A's colour and
    the given history (none: zeros), its detail over their mean."""
    hist = (torch.zeros_like(colour) if history is None
            else history.float() / 255.0)
    x = torch.cat([colour, hist], -1).movedim(-1, 0)[None]
    for i, (w, b) in enumerate(PARAMS):
        x = conv(x, w, b, precision)
        if i < len(PARAMS) - 1:
            x = F.relu(x)
    out = 0.5 * (colour + hist) + x[0].movedim(0, -1)
    return torch.round(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def display(b: torch.Tensor) -> torch.Tensor:
    """The RGBA8 frame a user sees: the blocks, opaque."""
    return torch.cat([b, torch.full_like(b[..., :1], 255)], -1)


class StubReference:
    """The stub's plain reference: its own stage A, stage B on the
    program's kept A and the given history, and the display frame of its
    own chain (its A through its B)."""

    @staticmethod
    def reference_frame(cfg, motion, k, device, control=False, given=None,
                        kept=None):
        history = (given or {}).get("history")
        precision = "tf32" if control else "f32"
        own = shaded(motion, k, control)
        out = {"color": display(blocks(own, history, precision)),
               "shaded": own}
        if kept is not None:
            out["blocks"] = blocks(kept["shaded"], history, precision)
        return out


class StubRenderer:
    """The program's side: stage A, then stage B in `precision` on the
    A it read and the previous frame's blocks; keeps `kept_a`, the A the
    scene hands on (that B read, unless a fault sets it otherwise)."""

    graphs = None

    def __init__(self, scene) -> None:
        self.scene = scene
        self.max_inflight = 1
        self.precision, self.stale_kept = "f32", False
        self.history = None
        self.kept_a = self.kept_b = None

    def draw_frame(self) -> StubOut:
        k = self.scene.k
        a = shaded(self.scene.motion, k)
        b = blocks(a, self.history, self.precision)
        if not (self.stale_kept and self.kept_a is not None):
            self.kept_a = a
        self.kept_b, self.history = b, b
        return StubOut(display(b), b, k, torch.zeros(2, dtype=torch.int32))


class StubScene:
    reference = StubReference
    KEPT = ("shaded", "blocks")

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
        r = self.renderer
        return {"shaded": r.kept_a, "blocks": r.kept_b}

    def given(self, prev_out: StubOut) -> dict:
        return {"history": prev_out.history, "step": prev_out.step}

    def close(self) -> None:
        pass

    def span_targets(self) -> list:
        return []


@pytest.fixture
def stub(monkeypatch):
    """The stub scene in place of the configurations' scenes, the
    harness's clock stepping 10 ms a reading (a window of 0.3 s holds
    about 30 frames, its samples drawn among the first 8); the
    reference's calls recorded as (step, control, given, kept)."""
    calls = []
    monkeypatch.setattr(harness, "scene_class", lambda cfg: StubScene)
    monkeypatch.setattr(harness, "SAMPLE_SPAN", 8)
    monkeypatch.setattr(harness, "time", SteppedClock())
    frame = StubReference.reference_frame

    def recorded(cfg, motion, k, device, control=False, given=None,
                 kept=None):
        calls.append((k, control, given, kept))
        return frame(cfg, motion, k, device, control, given, kept)

    monkeypatch.setattr(StubReference, "reference_frame",
                        staticmethod(recorded))
    return calls


def run(hook=None) -> dict:
    return harness.run_cell(CELL, SEED, 0.3, False, "cpu", hook=hook,
                            config=STUB_CFG)


def net_in_bf16(scene, loop):
    scene.renderer.precision = "bf16"


def kept_shade_stale(scene, loop):
    """The scene hands on the first frame's A: not the A that B read."""
    scene.renderer.stale_kept = True


def values(out: dict) -> dict:
    return {n: c["value"] for n, c in out["checks"].items()}


def test_a_sound_run_is_correct(stub):
    out = run()
    assert out["correct"], out["checks"]
    assert all(v == 0.0 for v in values(out).values())
    assert len(stub) == harness.SAMPLES + 1
    for _k, ctl, _given, kept in stub:
        assert not ctl and set(kept) == {"shaded", "blocks"}


def test_a_stage_in_bf16_fails_its_number_not_the_display_frame(stub):
    """The gap this path closes: the display frame's numbers pass a net
    run in bf16; the net's own number, on the program's input, fails it."""
    out = run(net_in_bf16)
    nums = values(out)
    assert not out["correct"], out["checks"]
    assert nums["blocks_diff_share"] > STUB_CFG["limits"]["blocks_diff_share"]
    assert check.verdict(nums, DISPLAY_LIMITS)[0], out["checks"]
    assert nums["shaded_err"] == 0.0


def test_a_kept_stage_other_than_the_one_read_is_not_correct(stub):
    out = run(kept_shade_stale)
    assert not out["correct"], out["checks"]
    assert values(out)["shaded_err"] > STUB_CFG["limits"]["shaded_err"]


class Undeclared(StubScene):
    """Keeps an array its KEPT does not name."""

    def kept(self, k: int) -> dict:
        return dict(super().kept(k), depth=self.renderer.kept_a[..., 0])


class Unreturned(Undeclared):
    """Keeps and names an array the reference returns none of."""

    KEPT = StubScene.KEPT + ("depth",)


@pytest.mark.parametrize("scene, match", [
    (Undeclared, "its KEPT names"),
    (Unreturned, "returns no array of that name")])
def test_a_kept_array_the_reference_cannot_check_raises(stub, monkeypatch,
                                                        scene, match):
    monkeypatch.setattr(harness, "scene_class", lambda cfg: scene)
    with pytest.raises(ValueError, match=match):
        run()


def test_the_control_lies_between_sound_runs_and_a_bf16_stage(stub):
    """The control steps B in TF32 from the very A and history one run
    of the program kept and was given, as the float32 step does; its
    share of differing blocks lies strictly between a sound run's and a
    bf16 net's, so a limit can be set between the two."""
    nums = control.control_numbers(CELL, SEED, "cpu", config=STUB_CFG,
                                   seconds=0.3)
    assert not check.verdict(nums, STUB_CFG["limits"])[0], nums
    assert len(stub) == 2 * (harness.SAMPLES + 1)
    for (k, ctl, given, kept), (k2, ctl2, given2, kept2) in zip(stub[::2],
                                                                stub[1::2]):
        assert (k, ctl, k2, ctl2) == (k, False, k, True)
        assert given2 is given and kept2 is kept
    del stub[:]
    sound = values(run())["blocks_diff_share"]
    bf16 = values(run(net_in_bf16))["blocks_diff_share"]
    assert sound < nums["blocks_diff_share"] < bf16, (sound, nums, bf16)


def todays_numbers(cls, cfg, motion, colour, kept, ctl: bool) -> dict:
    """The numbers as the comparison computed them before kept stages: the
    frame's, and the palettes' largest difference where the scene kept
    palettes; with `ctl` the TF32 reference's in the program's place."""
    want = cls.reference.reference_frame(cfg, motion, 2, "cpu", given={})
    if ctl:
        got = cls.reference.reference_frame(cfg, motion, 2, "cpu",
                                             control=True, given={})
        colour = got["color"]
        kept = ({"palettes": list(got["palettes"].numpy())}
                if "palettes" in got else {})
    nums = check.frame_numbers(colour, want["color"])
    if "palettes" in kept:
        p = torch.as_tensor(np.stack(kept["palettes"]))
        nums["palette_err"] = float((p - want["palettes"]).abs().max())
    return nums


@pytest.mark.parametrize("ctl", [False, True])
@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_the_configurations_numbers_are_todays(cell, ctl, tmp_path):
    cfg = small_config(cell)
    cls = harness.scene_class(cfg)
    assert not check.takes_kept(cls.reference)
    scene = cls(cfg, 4243, 240, torch.device("cpu"), str(tmp_path))
    try:
        for k in range(3):
            scene.step(k)
        out = scene.renderer.draw_frame()
        kept = scene.kept(2)
    finally:
        scene.close()
    assert set(kept) == set(getattr(cls, "KEPT", ()))
    want = todays_numbers(cls, cfg, scene.motion, out.color, kept, ctl)
    if ctl:
        kept = dict.fromkeys(kept)
    got = check.compare(cls, cfg, scene.motion, [(2, out.color, kept)],
                        "cpu", control=ctl)
    assert got == want
    assert ("palette_err" in got) == (cell.startswith("crowd"))
