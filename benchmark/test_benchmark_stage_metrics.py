"""The stage readers' split of synthetic profiler records by the program's
stage marks, and host_wait_ms from a tracer snapshot."""

import pytest

from benchmark import stages, trace
from benchmark.harness import Run, Window
from benchmark.metrics import binning_ms, geometry_ms, host_wait_ms, shading_ms

R = trace.Record


def mark(stage, t):
    return R(f"void (anonymous namespace)::stage_mark_{stage}"
             "(unsigned long long*)", t, t + 1)


def frame(t0):
    """One frame's marks and work from t0 µs: geometry 100 µs in two
    records, binning 30, visibility 40, shading 50, post 10."""
    return [mark("frame", t0), R("void at::native::clone", t0 + 2, t0 + 4),
            mark("geometry", t0 + 5),
            R("void at::native::elementwise_kernel<...>", t0 + 6, t0 + 66),
            R("void at::native::vectorized_gather_kernel", t0 + 66, t0 + 106),
            mark("binning", t0 + 110),
            R("void at::native::CatArrayBatchedCopy", t0 + 111, t0 + 141),
            mark("visibility", t0 + 142),
            R("void (anonymous namespace)::visibility_kernel<false>(x)",
              t0 + 143, t0 + 183),
            mark("shading", t0 + 184),
            R("void (anonymous namespace)::texel_kernel<false>(z)",
              t0 + 185, t0 + 235),
            mark("post", t0 + 236),
            R("void at::native::reduce_kernel", t0 + 237, t0 + 247),
            mark("end", t0 + 248)]


def stretch(n=2, outside=True):
    dev = []
    for k in range(n):
        t0 = 1000 * k
        if outside:                   # staging before, clones after
            dev.append(R("Memcpy HtoD (Pinned -> Device)", t0 - 50, t0 - 20))
        dev += frame(t0)
        if outside:
            dev.append(R("Memcpy DtoD (Device -> Device)", t0 + 260, t0 + 300))
    return trace.Stretch(n, dev, [])


def run_of(s):
    return Run(1.0, Window(1, [10.0], 0), trace.Spans(), s, None)


def test_stage_readers_split_per_frame():
    s = stretch()
    assert geometry_ms.read(run_of(s)) == pytest.approx(0.1)
    assert binning_ms.read(run_of(s)) == pytest.approx(0.03)
    assert shading_ms.read(run_of(s)) == pytest.approx(0.05)


def test_records_outside_the_marks_belong_to_no_stage():
    s = stretch()
    per = stages.split_us(s.device)
    assert per == pytest.approx({"frame": 4.0, "geometry": 200.0,
                                 "binning": 60.0, "visibility": 80.0,
                                 "shading": 100.0, "post": 20.0})
    assert per == stages.split_us(stretch(outside=False).device)
    # staging 30 µs and clones 40 µs a frame lie outside 248 + 1 µs
    busy_in = 2 + 100 + 30 + 40 + 50 + 10 + 7   # work + marks
    assert stages.inside_share(s.device) == pytest.approx(
        busy_in / (busy_in + 70))
    assert stages.inside_share(stretch(outside=False).device) == 1.0


def test_a_stretch_without_marks_reads_nothing():
    dev = [r for r in stretch().device if stages.mark_of(r.name) is None]
    s = trace.Stretch(2, dev, [])
    assert stages.split_us(dev) is None and stages.inside_share(dev) is None
    for reader in (geometry_ms, binning_ms, shading_ms):
        assert reader.read(run_of(s)) is None
        assert reader.read(run_of(None)) is None


def test_a_stage_without_its_mark_reads_nothing_and_one_without_work_0():
    dev = [r for r in stretch().device if stages.mark_of(r.name) != "binning"]
    s = trace.Stretch(2, dev, [])
    assert binning_ms.read(run_of(s)) is None
    # binning's records now run in the geometry stage
    assert geometry_ms.read(run_of(s)) == pytest.approx(0.13)
    empty = [r for r in stretch().device if "texel" not in r.name]
    assert shading_ms.read(run_of(trace.Stretch(2, empty, []))) == 0.0


def test_marks_are_no_kernel_of_the_frame_and_no_sentinel():
    for st in ("frame", "geometry", "shadow", "binning", "visibility",
               "resolve", "shading", "post", "end"):
        name = mark(st, 0).name
        assert stages.mark_of(name) == st
        assert trace.kernel_of(name) is None
        assert trace.SENTINEL not in name
    assert stages.mark_of("void at::native::elementwise_kernel") is None


def snap(frames, **waits):
    spans = {"state": {"seconds": 0.5, "calls": frames}}
    spans.update({f"wait.{k}": {"seconds": v, "calls": frames}
                  for k, v in waits.items()})
    return {"frames": frames, "spans": spans, "counters": {}}


def test_host_wait_ms_sums_every_wait_over_the_frames():
    assert host_wait_ms.from_snapshot(
        snap(32, pace=0.064, slot=0.001, readback=0.031)) == \
        pytest.approx(3.0)
    assert host_wait_ms.from_snapshot(snap(0, pace=0.1)) is None
    assert host_wait_ms.from_snapshot(snap(32)) is None
    assert host_wait_ms.from_snapshot({}) is None


def test_host_wait_ms_reads_the_programs_tracer():
    from trident_tpu_torch.utils import profiling

    t = profiling.TRACER
    saved = (t.on, dict(t.seconds), dict(t.calls), dict(t.counters),
             t.frames)
    try:
        t.reset()
        profiling.tracing(True)
        for _ in range(4):
            t.frame()
            with t.span("wait.pace"):
                pass
        profiling.tracing(False)
        t.seconds["wait.pace"] = 0.008
        assert host_wait_ms.read(run_of(None)) == pytest.approx(2.0)
    finally:
        t.reset()
        t.on, t.frames = saved[0], saved[4]
        t.seconds.update(saved[1])
        t.calls.update(saved[2])
        t.counters.update(saved[3])
