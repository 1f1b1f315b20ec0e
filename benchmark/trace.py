"""The traced stretch of a `--trace 1` run and the harness's spans.

Spans: the harness wraps the program's entry points of each layer (a
Renderer's `frame_bundle`, a Scene's `update`, the frame graphs' `run` and
`run_rows`) on the live objects of a traced run, and sums host-clock
seconds per call (`Spans`); a span that drains the card's queue first
times that wait apart. Inside the profiled stretch each wrapped call
is also a `record_function` range named `bench.<span>`, so that an idle
gap on the device can be named by what the host was doing.

The profiled stretch: `torch.profiler` over a fixed number of frames
after the measured window, bracketed by SENTINELS_BEFORE short spin
kernels before and one after (the card's tracer has lost up to the first
seven records of a window, and these are what it then loses). A stretch
counts only when it is whole: at least as many kernel records as the host
made kernel-launch calls, and for the frame graphs' replays each
hand-written kernel of the graph's launch list exactly replays × its
count. Up to ATTEMPTS stretches are profiled; with none whole the device
metrics are not measured.

The kernel-name table and the whole-window rule are copies of the
program's own timing tool (trident_tpu_torch/tools_dev/timing.py), kept
here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

SENTINEL = "spin_kernel"
SENTINEL_CYCLES = 2000
SENTINELS_BEFORE = 32
ATTEMPTS = 5
COPY_ACTIVITIES = ("Memcpy", "Memset")
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"}
GRAPH_LAUNCH = "cudaGraphLaunch"
SPAN_PREFIX = "bench."

# the hand-written kernels of the frame (csrc/*.cu), by the name of their
# wrapper in the frame graphs' launch lists, as the profiler names their
# device records
KERNEL_RECORDS = {
    "visibility": r"(?<!\w)visibility_kernel<false>",
    "visibility_depth": r"(?<!\w)visibility_kernel<true>",
    "visibility_ck": r"(?<!\w)visibility_ck_kernel(?!\w)",
    "visibility_resolve": r"(?<!\w)visibility_resolve_kernel(?!\w)",
    "visibility_resolve_vc": r"(?<!\w)visibility_resolve_vc_kernel(?!\w)",
    "resolve": r"(?<!\w)resolve_kernel(?!\w)",
    "resolve_vc": r"(?<!\w)resolve_vc_kernel(?!\w)",
    "resolve_tiled": r"(?<!\w)resolve_tiled_kernel(?!\w)",
    "resolve_tiled_vc": r"(?<!\w)resolve_tiled_vc_kernel(?!\w)",
    "texel": r"(?<!\w)texel_kernel<false>",
    "texel_planar": r"(?<!\w)texel_kernel<true>",
    "shadow_taps": r"(?<!\w)taps[14]_kernel(?!\w)",
    "warp": r"(?<!\w)warp_kernel(?!\w)",
    "visibility_band": r"(?<!\w)visibility_band_kernel<false>",
    "visibility_depth_band": r"(?<!\w)visibility_band_kernel<true>",
    "visibility_ck_band": r"(?<!\w)visibility_ck_band_kernel(?!\w)",
    "visibility_resolve_band":
        r"(?<!\w)visibility_resolve_band_kernel(?!\w)",
    "visibility_resolve_vc_band":
        r"(?<!\w)visibility_resolve_vc_band_kernel(?!\w)",
    "resolve_band": r"(?<!\w)resolve_band_kernel(?!\w)",
    "resolve_vc_band": r"(?<!\w)resolve_vc_band_kernel(?!\w)",
    "resolve_tiled_band": r"(?<!\w)resolve_tiled_band_kernel(?!\w)",
    "resolve_tiled_vc_band": r"(?<!\w)resolve_tiled_vc_band_kernel(?!\w)",
}
KERNEL_RECORDS.update({
    f"{name}_bf16": pattern.replace("_kernel", "_bf16_kernel")
    for name, pattern in list(KERNEL_RECORDS.items()) if "resolve" in name})
# the kernels that do the frame's visibility and attribute resolve (the
# colour pass; the shadow map's depth-only pass is other work)
RASTER_KERNELS = tuple(n for n in KERNEL_RECORDS
                       if n.startswith(("visibility", "resolve"))
                       and not n.startswith("visibility_depth"))


def kernel_of(record_name: str) -> Optional[str]:
    """The hand-written kernel a device record belongs to, or None."""
    for name, pattern in KERNEL_RECORDS.items():
        if re.search(pattern, record_name):
            return name
    return None


class Spans:
    """Host-clock seconds per call of each wrapped entry point."""

    def __init__(self) -> None:
        self.seconds = defaultdict(list)
        self.named = False          # record_function ranges on (profiling)

    def wrap(self, obj, attr: str, span: str, drain: bool = False) -> None:
        """Time every call of obj.attr from now on (an instance attribute
        that shadows the method). With `drain`, each call first waits for
        the work queued on the card, timed as the span `<span>_wait`, so
        that a call that ends by waiting for the card (a device-to-host
        copy) is timed for its own work."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            import torch

            if drain and torch.cuda.is_available():
                with self._range(span + "_wait"):
                    torch.cuda.synchronize()
            with self._range(span):
                out = fn(*args, **kwargs)
            return out

        setattr(obj, attr, timed)

    @contextmanager
    def _range(self, span: str):
        """Times the block into `span`; a record_function range of that
        name while profiling."""
        from torch.profiler import record_function

        ctx = (record_function(SPAN_PREFIX + span) if self.named
               else nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.seconds[span].append(time.perf_counter() - t0)

    def mean_ms(self, span: str) -> Optional[float]:
        s = self.seconds.get(span)
        return None if not s else 1e3 * sum(s) / len(s)


class Record(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Stretch(NamedTuple):
    """A whole profiled stretch of `frames` frames: the device records
    (sentinels dropped) and the harness's host ranges, both in the
    profiler's microseconds."""

    frames: int
    device: list
    host: list


def whole(n_kernels: int, n_launches: int, n_graphs: int, listed: dict,
          launch_list: dict) -> bool:
    """Whether a stretch holds every kernel it launched: as many kernel
    records as kernel-launch calls, and each replayed graph's hand-written
    kernels exactly n_graphs × their launches per replay."""
    if n_kernels <= 0 or n_kernels < n_launches:
        return False
    if n_graphs == 0:
        return True
    return bool(launch_list) and all(
        listed.get(name, 0) == count * n_graphs
        for name, count in launch_list.items())


def device_records(events) -> list:
    """The device's activity records among profiler events: the
    sentinels dropped, and the harness's own ranges too, which also
    appear on the device's timeline (as annotations spanning the work
    they launched) but are not work."""
    from torch.autograd import DeviceType

    return [Record(e.name, e.time_range.start, e.time_range.end)
            for e in events if e.device_type == DeviceType.CUDA
            and SENTINEL not in e.name and not e.name.startswith(SPAN_PREFIX)]


def profile_stretch(run_frames, frames: int, spans: Spans,
                    launch_list) -> Optional[Stretch]:
    """Profile run_frames(frames) until a stretch is whole (up to
    ATTEMPTS); `launch_list()` gives the replayed graph's kernels per
    replay afterwards. None when no stretch was whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans.named = True
    try:
        for _ in range(ATTEMPTS):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(SENTINELS_BEFORE):
                    torch.cuda._sleep(SENTINEL_CYCLES)
                run_frames(frames)
                torch.cuda._sleep(SENTINEL_CYCLES)
                torch.cuda.synchronize()
            events = prof.events()
            device = device_records(events)
            host = [e for e in events if e.device_type == DeviceType.CPU]
            n_launches = sum(e.name in LAUNCH_CALLS for e in host) \
                - SENTINELS_BEFORE - 1
            n_graphs = sum(e.name.startswith(GRAPH_LAUNCH) for e in host)
            n_kernels = sum(not r.name.startswith(COPY_ACTIVITIES)
                            for r in device)
            listed = defaultdict(int)
            for r in device:
                k = kernel_of(r.name)
                if k is not None:
                    listed[k] += 1
            if whole(n_kernels, n_launches, n_graphs, listed,
                     launch_list()):
                ranges = [Record(e.name[len(SPAN_PREFIX):],
                                 e.time_range.start, e.time_range.end)
                          for e in host if e.name.startswith(SPAN_PREFIX)]
                return Stretch(frames, device, ranges)
            print(f"trace: a stretch lost device records (kernels "
                  f"{n_kernels}, launches {n_launches}, graph replays "
                  f"{n_graphs}); profiling another", file=sys.stderr,
                  flush=True)
        return None
    finally:
        spans.named = False


def busy_union(records) -> tuple:
    """(busy µs, first start µs, last end µs) of device records: the
    length of the union of their intervals."""
    iv = sorted((r.start_us, r.end_us) for r in records)
    if not iv:
        return 0.0, 0.0, 0.0
    busy, (cs, ce) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    return busy, iv[0][0], max(e for _s, e in iv)


def idle_gaps(records) -> list:
    """(start µs, end µs) of every gap between the union's intervals."""
    iv = sorted((r.start_us, r.end_us) for r in records)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def breakdown(stretch: Stretch) -> dict:
    """The ten device operations that took most time (seconds summed by
    name) and the ten longest idle gaps, each named by the harness range
    open on the host at the gap's middle ("none" if no range was)."""
    per_op = defaultdict(float)
    for r in stretch.device:
        per_op[r.name] += (r.end_us - r.start_us) * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(stretch.device), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        open_ = [h for h in stretch.host if h.start_us <= mid <= h.end_us]
        name = min(open_, key=lambda h: h.end_us - h.start_us).name \
            if open_ else "none"
        named.append([name, (e - s) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
