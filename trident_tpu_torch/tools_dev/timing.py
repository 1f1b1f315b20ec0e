"""Timing on the card and the least time it could take (bound), shared by
chip_smoke.py and the probes.

bound() is the larger of a function's bytes (each input read once, each
output written once) over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(NVIDIA H100 SXM data sheet, at the 700 W power limit; card() gives the
limit the card is set to, smi_sample() the SM clock, power draw and
temperature beside a timing window). cuda_ms and device_busy take a
`flush` (l2_flush()) to time a kernel whose caller finds the 50 MB L2
cold.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 multiplies and adds per evaluated (triangle, pixel) pair of the
# visibility kernels: three edge functions (2 mul + 2 add each), zi and wi
# (3 mul + 2 add each); compares and the merge are not counted
VIS_OPS_PER_PAIR = 22
PROFILE_ATTEMPTS = 10      # profiling windows device_busy tries
L2_FLUSH_BYTES = 128 << 20  # traffic well past the H100's 50 MB L2
# the profiler's name for l2_flush's device-to-device copy
FLUSH_ACTIVITY = "Memcpy DtoD"
# the prefixes of the profiler's copy and fill records (all others are
# kernels), and the host calls that launch one kernel each
COPY_ACTIVITIES = ("Memcpy", "Memset")
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"}
# the host call that replays a captured CUDA graph: one call, many kernels
GRAPH_LAUNCH = "cudaGraphLaunch"
# torch.cuda._sleep's kernel, launched SENTINELS_BEFORE times before and
# once after each profiling window's calls, and its length in clock cycles
# (about 1 µs); the card's tracer has lost up to the first seven records
# of a window (late in a long process: every window of a phase at once)
SENTINEL = "spin_kernel"
SENTINEL_CYCLES = 2000
SENTINELS_BEFORE = 32
# each render-path kernel (by its wrapper's name in
# render/graphs.py::frame_kernels) as torch.profiler names its device
# records (csrc/*.cu; "void (anonymous namespace)::visibility_kernel<false>(…)")
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
    # the band instances of the banded frame (parallel/framebuffer.py)
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
# the bf16 instances (resolve_prec="bf16"): each resolve kernel's name
# with "_bf16" before "_kernel"
KERNEL_RECORDS.update({
    f"{name}_bf16": pattern.replace("_kernel", "_bf16_kernel")
    for name, pattern in list(KERNEL_RECORDS.items()) if "resolve" in name})


def record_counts(record_names) -> dict:
    """How many of the profiler's device records `record_names` belong to
    each render-path kernel (KERNEL_RECORDS), the kernels with none
    left out."""
    counts = {}
    for rec in record_names:
        for name, pattern in KERNEL_RECORDS.items():
            if re.search(pattern, rec):
                counts[name] = counts.get(name, 0) + 1
    return counts


def l2_flush(dev):
    """A callable that copies one L2_FLUSH_BYTES / 2 buffer on `dev` into
    another, evicting whatever the L2 holds. A same-dtype contiguous copy
    is one device-to-device memcpy (FLUSH_ACTIVITY), which device_busy
    tells apart from the timed function's kernels."""
    import torch

    src, dst = (torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.float32,
                            device=dev) for _ in range(2))
    return lambda: dst.copy_(src)


def cuda_ms(fn, reps: int = 10, warmup: int = 2, flush=None) -> float:
    """Median device time of fn() in ms (CUDA events around each call);
    with `flush`, flush() runs before each call, outside its events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def whole(n_activities: int, n_kernels: int, n_launches: int,
          n_graphs: int = 0, listed=None, launch_list=None) -> bool:
    """Whether a profiling window holds every kernel it launched: some
    device activity, and at least as many kernel records (n_kernels, the
    activities that are not COPY_ACTIVITIES) as the host made kernel
    launch calls (n_launches, LAUNCH_CALLS). The card's tracer can lose a
    window's device records, all of them or some; the host's launch calls,
    recorded beside them, say how many there must be.

    A graph replay is one host call (GRAPH_LAUNCH) for all of its
    kernels, so a window with n_graphs replays is whole only when it holds
    each kernel of the graph's launch list (`launch_list`, kernel name →
    launches per replay) exactly n_graphs times that count (`listed`, the
    window's records by kernel name, record_counts);
    without a launch list it is not whole."""
    if n_activities <= 0 or n_kernels < n_launches:
        return False
    if n_graphs == 0:
        return True
    return bool(launch_list) and all(
        (listed or {}).get(name, 0) == count * n_graphs
        for name, count in launch_list.items())


def _device_events(fn, reps: int, names=None, launch_list=None):
    """torch.profiler's CUDA activity records of `reps` fn() calls after
    one warm-up call (only those named in `names`, if given), or None.
    Each window brackets the calls with SENTINELS_BEFORE SENTINEL kernels
    before and one after, whose records are dropped, so that a record the
    tracer loses at a window's edge is a sentinel's; windows are profiled
    until one is whole() for fn's own records, launches and graph replays
    (held to `launch_list`, the replayed graph's), up to PROFILE_ATTEMPTS
    windows. Each window that loses records is reported on stderr
    (activities, kernels, kernel launches, sentinels, graph replays), and
    after PROFILE_ATTEMPTS such windows the result is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SENTINELS_BEFORE):
                torch.cuda._sleep(SENTINEL_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        events = [e for e in device if SENTINEL not in e.name
                  and (names is None or e.name in names)]
        n_kernels = sum(not e.name.startswith(COPY_ACTIVITIES)
                        for e in events)
        host = [e.name for e in prof.events()
                if e.device_type == DeviceType.CPU]
        n_launches = sum(n in LAUNCH_CALLS for n in host)
        n_graphs = sum(n.startswith(GRAPH_LAUNCH) for n in host)
        n_sentinels = sum(SENTINEL in e.name for e in device)
        seen.append((len(events), n_kernels,
                     n_launches - SENTINELS_BEFORE - 1, n_sentinels,
                     n_graphs))
        ok = whole(*seen[-1][:3], n_graphs,
                   record_counts(e.name for e in events), launch_list)
        if n_sentinels < SENTINELS_BEFORE + 1 or not ok:
            print(f"device_busy: a window of {reps} calls lost device "
                  f"records (activities, kernels, kernel launches, "
                  f"sentinels, graph replays): {seen[-1]}", file=sys.stderr,
                  flush=True)
        if ok:
            return events
    return None


def device_busy(fn, reps: int = 5, flush=None, launch_list=None):
    """(ms, launches) per fn() call of device activity — kernels, copies
    and fills as torch.profiler's CUDA activity records them — after one
    warm-up call: the card's busy time without the gaps between launches
    that CUDA events around a host-bound call also count. The card's
    tracer can lose device records; _device_events keeps only a window
    with a kernel record for each of fn's kernel launches, and where no
    window does, both numbers are NaN: not measured.
    With `flush`, flush() runs before each call, and only the activities
    whose names fn() alone records are counted; it raises if fn() itself
    records a FLUSH_ACTIVITY, which the flush's could not be told from.
    A fn that replays a CUDA graph needs the graph's `launch_list`
    (kernel name → launches per replay, render/graphs.py): whole() holds
    each window to it."""
    nan = float("nan")
    events = _device_events(fn, reps, launch_list=launch_list)
    if events is not None and flush is not None:
        names = {e.name for e in events}
        if any(FLUSH_ACTIVITY in n for n in names):
            raise RuntimeError(f"fn records a {FLUSH_ACTIVITY!r} activity: "
                               "the L2 flush's copy would count as fn's")

        def flushed():
            flush()
            fn()

        events = _device_events(flushed, reps, names, launch_list)
    if events is None:
        return nan, nan
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return busy_us / reps / 1e3, len(events) / reps


def graph_records(fn, launch_list, reps: int = 5):
    """The render-path kernels' device records (by kernel name) in one
    whole profiling window of `reps` fn() calls, each of which replays a
    CUDA graph with launch list `launch_list`, or None when no window was
    whole (_device_events)."""
    events = _device_events(fn, reps, launch_list=launch_list)
    return None if events is None else record_counts(e.name for e in events)


def uploads_per_call(fn, reps: int = 3, launch_list=None) -> float:
    """Host-to-device copies per fn() call in one whole profiling window
    (launch_list: as device_busy's), NaN when no window was whole."""
    events = _device_events(fn, reps, launch_list=launch_list)
    if events is None:
        return float("nan")
    return sum(e.name.startswith("Memcpy HtoD") for e in events) / reps


def bound(bytes_moved: float, ops: float = 0.0):
    """(bound_ms, bound_by) of a kernel's work on the card."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _smi(fields: str) -> str:
    """nvidia-smi's `--query-gpu=<fields>` line for the first card; raises
    if nvidia-smi fails."""
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return line


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them
    (`--query-gpu=name,power.limit`); raises if nvidia-smi fails."""
    return _smi("name,power.limit")


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now, as nvidia-smi
    prints them (`--query-gpu=clocks.sm,power.draw,temperature.gpu`)."""
    return _smi("clocks.sm,power.draw,temperature.gpu")


def timed_ms(fn, dev, reps: int = 10):
    """(CUDA-event median of `reps`, torch.profiler busy) ms of fn on the
    card; on the CPU one untimed call and None."""
    if dev.type != "cuda":
        fn()
        return None
    return cuda_ms(fn, reps=reps), device_busy(fn)[0]


def fmt_ms(ms) -> str:
    """timed_ms's result as "<events> ms events / <busy> ms busy", or "not
    measured" for None."""
    if ms is None:
        return "not measured"
    return f"{ms[0]:.4f} ms events / {ms[1]:.4f} ms busy"


def timed(fn, dev, reps: int = 10) -> str:
    """fmt_ms of timed_ms: fn's time on the card, or "not measured" after
    one untimed call on the CPU."""
    return fmt_ms(timed_ms(fn, dev, reps))
