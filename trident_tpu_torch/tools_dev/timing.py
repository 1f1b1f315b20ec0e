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

import statistics
import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 multiplies and adds per evaluated (triangle, pixel) pair of the
# visibility kernels: three edge functions (2 mul + 2 add each), zi and wi
# (3 mul + 2 add each); compares and the merge are not counted
VIS_OPS_PER_PAIR = 22
PROFILE_ATTEMPTS = 3       # profiling windows device_busy tries
L2_FLUSH_BYTES = 128 << 20  # traffic well past the H100's 50 MB L2
# the profiler's name for l2_flush's device-to-device copy
FLUSH_ACTIVITY = "Memcpy DtoD"


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


def _device_events(fn, reps: int, names=None) -> list:
    """torch.profiler's CUDA activity records of `reps` fn() calls after
    one warm-up call (only those named in `names`, if given); a window
    with none is profiled again, up to PROFILE_ATTEMPTS windows, then it
    raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and (names is None or e.name in names)]
        if events:
            return events
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{PROFILE_ATTEMPTS} windows")


def device_busy(fn, reps: int = 5, flush=None):
    """(ms, launches) per fn() call of device activity — kernels, copies
    and fills as torch.profiler's CUDA activity records them — after one
    warm-up call: the card's busy time without the gaps between launches
    that CUDA events around a host-bound call also count (the card's
    tracer sometimes delivers no activity for a window: _device_events).
    With `flush`, flush() runs before each call, and only the activities
    whose names fn() alone records are counted; it raises if fn() itself
    records a FLUSH_ACTIVITY, which the flush's could not be told from."""
    events = _device_events(fn, reps)
    if flush is not None:
        names = {e.name for e in events}
        if any(FLUSH_ACTIVITY in n for n in names):
            raise RuntimeError(f"fn records a {FLUSH_ACTIVITY!r} activity: "
                               "the L2 flush's copy would count as fn's")

        def flushed():
            flush()
            fn()

        events = _device_events(flushed, reps, names)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return busy_us / reps / 1e3, len(events) / reps


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
