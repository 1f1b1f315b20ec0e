"""The port's tracer (utils/profiling.py): host spans, waits, counters and
frames on the CPU, the ranges it emits only when switched on through its
own API, frames unchanged by it, the stage ring's reader on synthetic
rows; and, on the card (marker `card`; run there with `python3 -m pytest
--noconftest -m card tests/test_torch_tracing.py`), the stage marks inside
the replayed frame graph and the spans of the frame graphs.

No JAX here: the scenes are the port's own (tools_dev/scenes.py)."""

import json

import pytest
import torch

from trident_tpu_torch.anim.service import AnimationAssetService
from trident_tpu_torch.anim.system import AnimationSystem
from trident_tpu_torch.ecs.components import MeshComponent, TransformComponent
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.render.renderer import render_frame
from trident_tpu_torch.tools_dev import scenes
from trident_tpu_torch.utils import profiling
from trident_tpu_torch.utils.profiling import (
    RING_FRAMES,
    RING_HEADER,
    RING_SLOTS,
    SEQ_SLOT,
    STAGES,
    TRACER,
    Profiler,
    tracing,
)

DT = 1.0 / 60.0


def _reset_animation() -> None:
    AnimationAssetService.reset()
    AnimationSystem._players = {}
    AnimationSystem._samplers = None
    AnimationSystem._SAMPLER_CAP = 32


@pytest.fixture(autouse=True)
def fresh_state():
    tracing(False)
    TRACER.reset()
    _reset_animation()
    yield
    tracing(False)
    TRACER.reset()
    _reset_animation()


@pytest.fixture(scope="module")
def tube_path(tmp_path_factory):
    return scenes.write_tube_gltf(
        str(tmp_path_factory.mktemp("tube") / "tube.glb"), segments=16,
        rings=8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card tests/test_torch_tracing.py")
    from trident_tpu_torch import _build

    _build.load_library()
    return torch.device("cuda")


def field(device="cpu", size=64, config="spheres1080_1m"):
    """The 3×3 sphere grid at size²."""
    r, reg = scenes.build_bench_scene(3, device, config=config)
    r.set_viewport(0, size, size)
    return r, reg


def crowd(path, device="cpu"):
    """2×2 loaded, animated tubes at 64², playing."""
    return scenes.loaded_crowd(device, path, grid=2, width=64, height=64)


def crowd_frames(c, n):
    for _ in range(n):
        c.scene.update(DT)
        c.renderer.draw_frame()


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               ((a.color, b.color), (a.depth.view(torch.int32),
                                     b.depth.view(torch.int32)),
                (a.tri_id, b.tri_id), (a.aux, b.aux)))


# -- the tracer on the CPU ----------------------------------------------------

def test_tracing_off_calls_no_record_function(monkeypatch, tube_path):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    c = crowd(tube_path)
    crowd_frames(c, 3)
    assert calls == [] and TRACER.frames == 0 and not TRACER.calls
    assert TRACER.span("state") is TRACER.span("anim")    # the null span
    tracing(True)
    crowd_frames(c, 1)
    assert {"trident.state", "trident.anim.readback",
            "trident.submit"} <= set(calls)


def test_frames_are_bit_equal_with_tracing_on_and_off(tmp_path):
    r_off, reg_off = field()
    r_on, reg_on = field()
    inp = r_off.frame_inputs()
    off = render_frame(**inp)
    scenes.rotate(reg_off, 3)
    moved_off = r_off.render_viewport()
    p = Profiler(str(tmp_path))
    p.start()
    on = render_frame(**inp)
    scenes.rotate(reg_on, 3)
    moved_on = r_on.render_viewport()
    assert p.stop()
    assert TRACER.calls["state"] == 1
    assert same(off, on) and same(moved_off, moved_on)
    assert not same(off, moved_on)


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"
                and e.get("name", "").startswith("trident.")]


def _parent(name: str):
    """The span a span nests in: its prefix for two-part names under
    state, anim and submit; the sampler's copy for its wait."""
    if name in ("trident.wait.readback", "trident.wait.upload"):
        return {"trident.wait.readback": "trident.anim.readback",
                "trident.wait.upload": "trident.anim.sample"}[name]
    head, _, _tail = name.rpartition(".")
    return head if head in ("trident.state", "trident.anim",
                            "trident.submit") else None


def test_profiler_trace_nests_the_programs_spans(tmp_path, tube_path):
    c = crowd(tube_path)
    crowd_frames(c, 1)
    p = Profiler(str(tmp_path))
    p.start()
    crowd_frames(c, 2)
    path = p.stop()
    events = _events(path)
    names = {e["name"] for e in events}
    want = {"trident." + n for n in (
        "state", "state.gather", "state.plan", "state.params",
        "state.lights", "state.pack", "state.key", "stats", "anim",
        "anim.walk", "anim.sample", "wait.upload", "anim.readback",
        "wait.readback",
        "submit", "submit.eager")}
    assert want <= names, want - names
    for e in events:
        parent = _parent(e["name"])
        if parent is None:
            continue
        assert any(o["name"] == parent and o["tid"] == e["tid"]
                   and o["ts"] <= e["ts"] + 1e-3
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1e-3
                   for o in events), e["name"]
    assert sum(e["name"] == "trident.state" for e in events) == 2
    assert TRACER.frames == 2 and not TRACER.on


def test_a_foreign_profiler_session_accumulates_without_ranges(tube_path):
    from torch.profiler import ProfilerActivity, profile

    c = crowd(tube_path)
    crowd_frames(c, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        crowd_frames(c, 2)
    names = [e.name for e in prof.events()]
    assert names and not [n for n in names if "trident." in n]
    assert TRACER.frames == 2
    for span in ("state", "state.gather", "anim", "anim.walk",
                 "anim.sample", "wait.upload", "anim.readback",
                 "wait.readback", "submit", "stats"):
        assert TRACER.calls[span] == 2, span
    crowd_frames(c, 1)                         # the session is over
    assert TRACER.frames == 2 and TRACER.calls["anim"] == 2


def test_counters_and_frames_tick_once_per_frame_and_reset_clears():
    r, reg = field()
    tracing(True)
    for k in range(3):
        scenes.rotate(reg, k)
        r.render_viewport()
    r.render_viewport()                        # unchanged: the idle cache
    snap = TRACER.snapshot()
    assert snap["frames"] == 4 and TRACER.frames == 4
    spans, counters = snap["spans"], snap["counters"]
    assert spans["state"]["calls"] == 4 and spans["stats"]["calls"] == 4
    assert spans["submit"]["calls"] == spans["submit.eager"]["calls"] == 3
    assert counters["idle_cache.hits"] == 1
    assert counters["draw.triangles"] == 4 * r.stats_triangles
    # one plan and its corner table, one texture table, this version
    assert counters["upload.geometry"] == 2
    assert counters["upload.textures"] == 1
    assert counters["graph.captures"] == \
        profiling.compilation_stats().render_frame_variants
    assert counters["graph.evictions"] == 0
    assert TRACER.total("idle_cache.hits") == 1
    assert TRACER.total("state") == spans["state"]["seconds"] > 0
    assert TRACER.mean_ms("state") == pytest.approx(
        1e3 * spans["state"]["seconds"] / 4)
    assert TRACER.mean_ms("submit.capture") is None
    assert TRACER.host_wait_ms() == 0.0        # no wait on the CPU
    e = reg.create()                           # a new geometry and plan
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    r.render_viewport()
    assert TRACER.snapshot()["counters"]["upload.geometry"] == 4
    TRACER.reset()
    snap = TRACER.snapshot()
    assert snap["frames"] == 0 and not snap["spans"]
    assert set(snap["counters"]) == {"graph.captures", "graph.evictions"}
    assert TRACER.total("idle_cache.hits") == 0
    assert TRACER.host_wait_ms() is None and TRACER.on


def test_stats_triangles_follow_the_plan():
    """stats_triangles is counted once per plan, and stays the sum of the
    drawn meshes' triangles as the draws change."""
    r, reg = field()
    r.render_viewport()
    per = r.geometry.packed().draw_infos

    def drawn():
        return sum(per[m.mesh_index].index_count // 3
                   for _e, (m,) in reg.view(MeshComponent))

    sphere = drawn() // 9
    assert (r.stats_models, r.stats_triangles) == (9, drawn())
    reg.destroy(next(e for e, _c in reg.view(MeshComponent)))
    r.render_viewport()
    assert (r.stats_models, r.stats_triangles) == (8, 8 * sphere)
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    r.render_viewport()
    per = r.geometry.packed().draw_infos
    assert (r.stats_models, r.stats_triangles) == (9, 8 * sphere + 12)
    assert r.stats_triangles == drawn()


def test_marks_do_nothing_off_the_card():
    r, reg = field()
    r.render_viewport()
    assert profiling.stage_ms() == {} or torch.cuda.is_available()
    assert profiling.stage_ms(device="cpu") == {}
    profiling.stage_mark("geometry", torch.device("cpu"))
    assert not [k for k, v in profiling._rings.items()
                if v.device.type == "cpu"]


# -- the stage ring's reader (the card's ring, laid out by hand) -----------

def ring_of(frames, seq):
    """A host copy of a ring whose counter is `seq`, with `frames`
    {sequence: {stage: ns}} written into their rows."""
    ring = [0] * (RING_HEADER + RING_FRAMES * RING_SLOTS)
    ring[0], ring[1] = seq, 1
    for s, stamps in frames.items():
        o = RING_HEADER + (s % RING_FRAMES) * RING_SLOTS
        ring[o + SEQ_SLOT] = s
        for stage, t in stamps.items():
            ring[o + STAGES.index(stage)] = t
    return ring


def whole(t0, shadow=False):
    stamps = {"frame": t0, "geometry": t0 + 10_000, "binning": t0 + 510_000,
              "visibility": t0 + 610_000, "resolve": t0 + 910_000,
              "shading": t0 + 1_010_000, "post": t0 + 1_510_000,
              "end": t0 + 1_610_000}
    if shadow:
        stamps["shadow"] = t0 + 300_000
    return stamps


def test_stage_rows_keep_whole_frames_newest_first():
    frames = {s: whole(10_000_000 * s) for s in range(70, 75)}
    frames[75] = {"frame": 750_000_000, "geometry": 750_010_000}  # running
    ring = ring_of(frames, 75)
    rows = profiling.stage_rows(ring, 3)
    assert [r[SEQ_SLOT] for r in rows] == [74, 73, 72]
    assert len(profiling.stage_rows(ring, 100)) == 5
    stale = ring_of({10: whole(1)}, 10 + RING_FRAMES)   # overwritten since
    assert profiling.stage_rows(stale, 4) == []
    assert profiling.stage_rows(ring_of({}, 0), 4) == []


def test_stage_split_runs_each_stage_to_the_next_mark():
    rows = profiling.stage_rows(ring_of({1: whole(1_000), 2: whole(
        5_000_000, shadow=True)}, 2), 2)
    got = profiling.stage_split(rows)
    assert got["frame"] == pytest.approx(0.01)
    assert got["geometry"] == pytest.approx((0.5 + 0.29) / 2)
    assert got["shadow"] == pytest.approx(0.21 / 2)
    assert got["binning"] == pytest.approx(0.1)
    assert got["visibility"] == pytest.approx(0.3)
    assert got["resolve"] == pytest.approx(0.1)
    assert got["shading"] == pytest.approx(0.5)
    assert got["post"] == pytest.approx(0.1)
    assert got["frame_total"] == pytest.approx(1.61)
    assert "end" not in got
    assert profiling.stage_split([]) == {}


def test_stages_end_with_the_upscalers_two_before_end():
    assert STAGES == ("frame", "geometry", "shadow", "binning", "visibility",
                      "resolve", "shading", "post", "warp", "upscale", "end")
    assert STAGES.index("end") < SEQ_SLOT < RING_SLOTS


def test_stage_split_runs_post_to_warp_and_upscale_to_end():
    """An upscaled frame's post stage ends at its warp mark, the warp at
    the upscale mark, the upscale at the end mark; a frame without the two
    marks runs post to end, as before."""
    up = dict(whole(1_000), end=1_000 + 4_110_000, warp=1_000 + 1_610_000,
              upscale=1_000 + 1_710_000)
    rows = profiling.stage_rows(ring_of({1: up, 2: whole(9_000_000)}, 2), 2)
    got = profiling.stage_split(rows[1:])
    assert got["post"] == pytest.approx(0.1)
    assert got["warp"] == pytest.approx(0.1)
    assert got["upscale"] == pytest.approx(2.4)
    assert got["frame_total"] == pytest.approx(4.11)
    both = profiling.stage_split(rows)
    assert both["post"] == pytest.approx(0.1)
    assert both["upscale"] == pytest.approx(1.2)
    assert "warp" not in profiling.stage_split(rows[:1])


def upscaled_field(device="cpu", size=64):
    """The 3×3 sphere grid at size², rendered at half size and rebuilt by
    the shipped 2× net."""
    r, reg = scenes.build_bench_scene(3, device, ai=True)
    r.set_viewport(0, size, size)
    return r, reg


def test_upscale_counters_tick_once_a_frame_and_no_history_on_a_reset():
    r, reg = upscaled_field()
    tracing(True)
    for k in range(3):
        scenes.rotate(reg, k)
        r.render_viewport()
    r.render_viewport()                        # unchanged: the idle cache
    counters = TRACER.snapshot()["counters"]
    assert counters["upscale.frames"] == 3
    assert counters["upscale.no_history"] == 1
    r.prev_state = None                        # a temporal reset
    scenes.rotate(reg, 3)
    r.render_viewport()
    scenes.rotate(reg, 4)
    r.render_viewport()
    counters = TRACER.snapshot()["counters"]
    assert counters["upscale.frames"] == 5
    assert counters["upscale.no_history"] == 2
    plain, preg = field()
    TRACER.reset()
    plain.render_viewport()
    assert not {"upscale.frames", "upscale.no_history"} & set(
        TRACER.snapshot()["counters"])


# -- on the card -------------------------------------------------------------

@pytest.mark.card
def test_marks_stamp_every_stage_of_each_replay_in_order(card):
    """Replays advance the ring's counter; only while tracing is on do
    they stamp their rows, every stage in order."""
    r, reg = field(card)
    ring = profiling.stage_ring(card)
    r.render_viewport()                       # the capture
    seq0 = int(ring[0])
    for k in range(3):
        scenes.rotate(reg, k)
        r.render_viewport()
    assert int(ring[0]) == seq0 + 3
    assert not [row for row in profiling.stage_rows(ring.cpu().tolist(), 8)
                if row[SEQ_SLOT] > seq0]
    tracing(True)
    for k in range(3, 8):
        scenes.rotate(reg, k)
        r.render_viewport()
    assert r.graphs.captures == 1 and r.graphs.replays == 9
    rows = profiling.stage_rows(ring.cpu().tolist(), 5)
    assert [row[SEQ_SLOT] for row in rows] == list(range(seq0 + 8,
                                                         seq0 + 3, -1))
    unstamped = ("shadow", "warp", "upscale")
    for row in rows:
        stamps = [row[STAGES.index(s)] for s in STAGES if s not in unstamped]
        assert all(stamps) and stamps == sorted(stamps), row
        assert not [s for s in unstamped if row[STAGES.index(s)]]
    got = profiling.stage_ms(last=4, device=card)
    assert set(got) == {"frame", "geometry", "binning", "visibility",
                        "resolve", "shading", "post", "frame_total"}
    assert sum(v for k, v in got.items() if k != "frame_total") == \
        pytest.approx(got["frame_total"])


@pytest.mark.card
def test_an_upscaled_replay_stamps_warp_and_upscale_before_end(card):
    """The upscaled frame's replays stamp every stage but the light pass's
    in order, post then warp, upscale and end; the warp and upscale stages
    take time and the stages sum to the frame."""
    r, reg = upscaled_field(card)
    ring = profiling.stage_ring(card)
    r.render_viewport()                       # no history: its own graph
    scenes.rotate(reg, 1)
    r.render_viewport()                       # the warping frame's capture
    tracing(True)
    for k in range(2, 6):
        scenes.rotate(reg, k)
        r.render_viewport()
    rows = profiling.stage_rows(ring.cpu().tolist(), 4)
    assert len(rows) == 4
    for row in rows:
        stamps = [row[STAGES.index(s)] for s in STAGES if s != "shadow"]
        assert all(stamps) and stamps == sorted(stamps), row
    got = profiling.stage_ms(last=4, device=card)
    assert got["warp"] > 0 and got["upscale"] > 0
    assert sum(v for k, v in got.items() if k != "frame_total") == \
        pytest.approx(got["frame_total"])


@pytest.mark.card
def test_the_light_pass_has_its_mark(card):
    tracing(True)
    r, reg = field(card, config="shadows1080")
    r.render_viewport()
    got = profiling.stage_ms(last=1, device=card)
    assert got["shadow"] > 0 and got["geometry"] > 0


@pytest.mark.card
def test_card_spans_waits_and_no_program_range_in_a_foreign_session(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r, reg = field(card)
    r.max_inflight = 1
    for k in range(3):
        scenes.rotate(reg, k)
        r.draw_frame()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(3, 7):
            scenes.rotate(reg, k)
            r.draw_frame()
        torch.cuda.synchronize()
    events = prof.events()
    assert not [e.name for e in events if "trident." in e.name]
    marks = [e.name for e in events if e.device_type == DeviceType.CUDA
             and "stage_mark_" in e.name]
    assert len(marks) == 4 * 8
    from trident_tpu_torch.tools_dev.timing import record_counts

    assert record_counts(marks) == {}
    for span in ("submit.stage", "submit.replay", "submit.clone",
                 "wait.pace", "wait.slot"):
        assert TRACER.calls[span] >= 3, span
    assert TRACER.calls["submit.capture"] == 0
    assert TRACER.frames == 4 and TRACER.host_wait_ms() > 0
    assert TRACER.snapshot()["counters"]["upload.bytes"] > 0
