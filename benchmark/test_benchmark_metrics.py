"""The readers' arithmetic on synthetic windows and profiler records."""

import statistics
import time

import numpy as np
import pytest

from benchmark import trace, work
from benchmark.harness import Run, Window
from benchmark.metrics import (
    csrc_ms,
    device_idle,
    frame_ms,
    frame_p95_ms,
    raster_roofline,
    submit_us,
    torch_ops_ms,
)

R = trace.Record


def run_of(times=(10.0,), stretch=None, raster=None, spans=None):
    return Run(1.0, Window(len(times), list(times), 0),
               spans or trace.Spans(), stretch, raster)


def test_frame_ms_is_the_window_over_its_frames():
    assert frame_ms.read(run_of([10.0, 21.0, 30.0, 44.0])) == 11.0


def test_intervals_run_from_the_start_mark():
    got = frame_p95_ms.intervals([10.0, 21.0, 30.0, 44.0])
    assert got.tolist() == [10.0, 11.0, 9.0, 14.0]


def test_p95_of_the_intervals():
    rng = np.random.default_rng(3)
    iv = rng.uniform(5.0, 15.0, 1000)
    times = np.cumsum(iv).tolist()
    want = float(np.percentile(iv, 95))
    assert frame_p95_ms.read(run_of(times)) == pytest.approx(want)
    # statistics' inclusive quantiles agree with numpy's linear rule
    assert want == pytest.approx(
        statistics.quantiles(iv, n=20, method="inclusive")[-1])


def test_one_slow_frame_in_twenty_sets_the_p95():
    iv = [10.0] * 95 + [50.0] * 5
    assert frame_p95_ms.read(run_of(np.cumsum(iv).tolist())) == \
        pytest.approx(10.0 + 0.05 * 40.0)


def stretch():
    dev = [R("void (anonymous namespace)::visibility_kernel<false>(x)",
             0, 300),
           R("void (anonymous namespace)::resolve_kernel(y)", 300, 360),
           R("void at::native::elementwise_kernel<...>", 360, 1000),
           R("Memcpy DtoD (Device -> Device)", 1500, 1600),
           R("void (anonymous namespace)::texel_kernel<false>(z)",
             1550, 1650)]
    host = [R("host_state", 900, 1400), R("submit", 1400, 1450)]
    return trace.Stretch(2, dev, host)


def test_busy_union_and_idle_share():
    s = stretch()
    busy, first, last = trace.busy_union(s.device)
    assert (busy, first, last) == (1150, 0, 1650)
    assert device_idle.read(run_of(stretch=s)) == pytest.approx(
        100 * (1 - 1150 / 1650))


def test_kernel_and_torch_time_split_per_frame():
    s = stretch()
    assert csrc_ms.read(run_of(stretch=s)) == pytest.approx(0.46 / 2)
    assert torch_ops_ms.read(run_of(stretch=s)) == pytest.approx(0.74 / 2)


def test_raster_roofline_counts_only_visibility_and_resolve():
    w = work.RasterWork(100, 1000, 50, 22e3, 3.35e6)    # 1 µs of bytes
    got = raster_roofline.read(run_of(stretch=stretch(), raster=w))
    assert got == pytest.approx(100 * 0.001 / (0.36 / 2))


def test_no_stretch_reads_nothing():
    for mod in (csrc_ms, torch_ops_ms, device_idle, raster_roofline):
        assert mod.read(run_of()) is None
    assert submit_us.read(run_of()) is None


def test_breakdown_names_a_gap_by_the_open_host_range():
    b = trace.breakdown(stretch())
    assert b["idle_gaps"] == [["host_state", pytest.approx(500e-6)]]
    assert b["device_ops"][0][0].startswith("void at::native")


def test_whole_window_rule():
    assert trace.whole(10, 10, 0, {}, {})
    assert not trace.whole(9, 10, 0, {}, {})
    assert trace.whole(10, 2, 3, {"visibility": 3, "resolve": 3},
                       {"visibility": 1, "resolve": 1})
    assert not trace.whole(10, 2, 3, {"visibility": 2, "resolve": 3},
                           {"visibility": 1, "resolve": 1})
    assert not trace.whole(10, 2, 3, {}, {})


def test_kernel_table_tells_colour_from_depth_only_visibility():
    assert trace.kernel_of("visibility_kernel<false>(a)") == "visibility"
    assert trace.kernel_of("visibility_kernel<true>(a)") == \
        "visibility_depth"
    assert "visibility_depth" not in trace.RASTER_KERNELS
    assert "resolve_vc_bf16" in trace.RASTER_KERNELS
    assert trace.kernel_of("void at::native::vectorized_kernel") is None


def test_spans_mean():
    s = trace.Spans()

    class Obj:
        def f(self, x):
            return x + 1

    o = Obj()
    s.wrap(o, "f", "span")
    assert o.f(1) == 2 and o.f(2) == 3
    assert len(s.seconds["span"]) == 2 and s.mean_ms("span") >= 0
    assert s.mean_ms("other") is None


def test_a_draining_span_times_the_wait_apart(monkeypatch):
    """With drain, the card's queue is waited for before the call, and
    that wait is its own span, not the call's."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: (calls.append("sync"), time.sleep(0.05)))
    s = trace.Spans()

    class Obj:
        def f(self):
            calls.append("f")

    o = Obj()
    s.wrap(o, "f", "anim", drain=True)
    o.f()
    assert calls == ["sync", "f"]
    assert s.mean_ms("anim_wait") >= 50 and s.mean_ms("anim") < 50


def test_device_records_drop_sentinels_and_the_harness_ranges():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, a, b):
        return NS(name=name, device_type=dev, time_range=NS(start=a, end=b))

    got = trace.device_records([
        ev("bench.submit", DeviceType.CUDA, 0, 100),
        ev("spin_kernel", DeviceType.CUDA, 0, 1),
        ev("resolve_kernel", DeviceType.CUDA, 10, 20),
        ev("bench.submit", DeviceType.CPU, 0, 5)])
    assert got == [R("resolve_kernel", 10, 20)]
