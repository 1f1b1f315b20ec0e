"""Cells, configurations, traffic and metrics are found by name in files
of their own; BENCHMARK.json names what those files hold."""

import json
import shutil
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parent.parent
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_metric_has_a_reader_of_its_kind():
    found = harness.readers()
    b = bench()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert m["name"] in found, m["name"]
            assert found[m["name"]].KIND == kind
            assert found[m["name"]].UNIT == m["unit"]
    assert set(found) == {m["name"] for k in ("end_to_end", "per_layer")
                          for m in b[k]}


def test_every_workload_is_a_cell_file():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        c, cfg, traffic = harness.cell(w["name"])
        assert {k: c[k] for k in ("name", "config", "traffic", "chips",
                                  "why")} == w
        assert cfg["name"] == w["config"] and w["config"] in configs
        assert configs[w["config"]]["reduced"] == cfg["reduced"]
        assert configs[w["config"]]["source"] == cfg["source"]
        assert traffic == harness.load("traffic", w["traffic"])
        assert set(traffic) == {"loop", "in_flight", "cycle"}
        assert harness.scene_class(cfg) is not None
        assert harness.loop_class(traffic) is not None
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = ([m["name"] for k in ("end_to_end", "per_layer") for m in b[k]]
             + [w["name"] for w in b["workloads"]]
             + [c["name"] for c in b["configs"]]
             + [w["traffic"] for w in b["workloads"]])
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64, n
    for k in ("end_to_end", "per_layer"):
        for m in b[k]:
            assert set(m["unit"]) <= NAME_CHARS | {"/", "%"}, m["unit"]


def test_an_added_cell_is_found_from_its_files_alone(tmp_path, monkeypatch,
                                                     small):
    root = tmp_path / "benchmark"
    for kind in ("cells", "configs", "traffic"):
        shutil.copytree(harness.ROOT / kind, root / kind)
    (root / "cells" / "field1m_1080.short.json").write_text(json.dumps({
        "name": "field1m_1080.short", "config": "field1m_1080",
        "traffic": "short", "chips": 1, "why": "a test's cell"}))
    (root / "traffic" / "short.json").write_text(json.dumps(
        {"loop": "draw", "in_flight": 1, "cycle": 2}))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "WARMUP", 1)
    c, cfg, t = harness.cell("field1m_1080.short")
    assert (c["config"], t["in_flight"]) == ("field1m_1080", 1)
    out = harness.run_cell("field1m_1080.short", 7, 0.2, False, "cpu",
                           config=small("field1m_1080.dynamic", 64))
    assert out["attempted"] >= 1 and set(out["metrics"]) == {
        "frame_ms", "frame_p95_ms", "setup_s"}


def test_an_added_loop_is_found_from_its_file_alone(tmp_path, monkeypatch):
    """A traffic mix that needs a loop of its own names a new module in
    benchmark/loops/; nothing else is edited."""
    import benchmark.loops
    from benchmark.loops import rows

    (tmp_path / "replay_twice.py").write_text(
        "from benchmark.loops.rows import RowsLoop\n"
        "class ReplayTwice(RowsLoop):\n"
        "    pass\n"
        "LOOP = ReplayTwice\n")
    monkeypatch.setattr(benchmark.loops, "__path__",
                        list(benchmark.loops.__path__) + [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "benchmark.loops.replay_twice",
                        raising=False)
    loop = harness.loop_class({"loop": "replay_twice"})
    assert issubclass(loop, rows.RowsLoop) and loop is not rows.LOOP
    assert loop.ref_step(250, {"cycle": 240}) == 10


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        harness.load("cells", "../BENCHMARK")
    with pytest.raises(ValueError):
        harness.loop_class({"loop": "rows.LOOP"})
