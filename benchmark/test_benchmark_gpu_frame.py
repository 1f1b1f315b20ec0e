"""The card's time a frame (`gpu_frame_ms`): the marks before each frame
graph's replay, the reader's arithmetic, and which cells report which
metrics by BENCHMARK.json."""

import json
from pathlib import Path

import torch

from benchmark import harness, trace
from benchmark.harness import Run, Window
from benchmark.metrics import (
    frame_ms,
    frame_p95_ms,
    gpu_frame_ms,
    host_paced_frame_ms,
    host_paced_frame_p95_ms,
)

REPO = Path(__file__).resolve().parent.parent
DRAW_FIELD = "field1m_1080.dynamic"


class CardClock:
    """A clock that says it is on the card and counts its marks."""

    cuda = True

    def __init__(self) -> None:
        self.count = 0

    def mark(self):
        self.count += 1
        return self.count


def test_a_mark_before_each_replay_and_undone_after(monkeypatch):
    def replay(self):
        return "replayed"

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    starts, clock = [], CardClock()
    undo = harness._mark_replays(clock, starts)
    assert torch.cuda.CUDAGraph.replay(object()) == "replayed"
    assert torch.cuda.CUDAGraph.replay(object()) == "replayed"
    assert starts == [1, 2]
    undo()
    assert torch.cuda.CUDAGraph.replay is replay


def test_no_marks_off_the_card(monkeypatch):
    def replay(self):
        return None

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    clock = harness.Clock("cpu")
    undo = harness._mark_replays(clock, [])
    assert torch.cuda.CUDAGraph.replay is replay
    undo()


def run_of(times, device=None):
    return Run(1.0, Window(len(times), list(times), 0, device),
               trace.Spans(), None, None)


def test_gpu_frame_ms_is_the_card_time_over_every_frame():
    assert gpu_frame_ms.read(run_of([10.0, 20.0, 30.0, 40.0],
                                    [7.0, 7.5, 0.0, 7.5])) == 5.5
    assert gpu_frame_ms.read(run_of([10.0])) is None


def test_host_paced_readers_read_the_frame_metrics():
    run = run_of([10.0, 21.0, 30.0, 44.0])
    assert host_paced_frame_ms.read(run) == frame_ms.read(run)
    assert host_paced_frame_p95_ms.read(run) == frame_p95_ms.read(run)


def test_each_cell_reports_the_metrics_benchmark_json_gives_it():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        for kind in ("end_to_end", "per_layer"):
            want = {m["name"] for m in bench[kind]
                    if w["name"] in m.get("workloads", [w["name"]])}
            assert harness.reported(w["name"], kind) == want
    assert harness.reported(DRAW_FIELD, "end_to_end") == {
        "gpu_frame_ms", "setup_s"}
    assert "frame_ms" in harness.reported("crowd144_1080.animated",
                                          "end_to_end")
    assert harness.reported("field1m_1080.not_listed", "end_to_end") is None


def test_the_field_draw_run_reports_only_its_metrics(small):
    out = harness.run_cell(DRAW_FIELD, 11, 0.2, False, "cpu",
                           config=small(DRAW_FIELD, 64))
    assert set(out["metrics"]) <= {"gpu_frame_ms", "setup_s"}
    assert "setup_s" in out["metrics"]
