"""Timing on the card and the least time it could take (bound), shared by
chip_smoke.py and the probes.

bound() is the larger of a function's bytes (each input read once, each
output written once) over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(NVIDIA H100 SXM data sheet, at the 700 W power limit; card() gives the
limit the card is set to).
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


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(fn, reps: int = 5):
    """(ms, launches) per fn() call of device activity — kernels, copies
    and fills as torch.profiler's CUDA activity records them — after one
    warm-up call: the card's busy time without the gaps between launches
    that CUDA events around a host-bound call also count. A profiling
    window that records no device activity at all (the card's tracer
    sometimes delivers none) is profiled again, up to PROFILE_ATTEMPTS
    windows; then it raises."""
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
                  if e.device_type == DeviceType.CUDA]
        if events:
            busy_us = sum(e.time_range.elapsed_us() for e in events)
            return busy_us / reps / 1e3, len(events) / reps
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{PROFILE_ATTEMPTS} windows")


def bound(bytes_moved: float, ops: float = 0.0):
    """(bound_ms, bound_by) of a kernel's work on the card."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them
    (`--query-gpu=name,power.limit`); raises if nvidia-smi fails."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return line


def timed(fn, dev, reps: int = 10) -> str:
    """fn's time on the card, "<events> ms events / <busy> ms busy" (CUDA-
    event median of `reps`, torch.profiler busy); on the CPU one untimed
    call and "not measured"."""
    if dev.type != "cuda":
        fn()
        return "not measured"
    return (f"{cuda_ms(fn, reps=reps):.4f} ms events / "
            f"{device_busy(fn)[0]:.4f} ms busy")
